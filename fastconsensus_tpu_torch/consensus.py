"""The consensus driver: iterate rounds to delta-convergence, then re-detect.

Counterpart of the solo ``run_consensus`` of ``fastconsensus_tpu/
consensus.py``, with everything that changes results kept: warm-started
detection (capped-sweep warm variant), endgame key alignment, stagnation
refresh (policy.stale / policy.stalled), re-derivation of the dense/hybrid
budgets when they starve (policy.budgets_stale), auto-growth of the slab
with a deterministic replay of the saturating round, both wedge samplers,
and checkpoint/resume in the reference's file format
(``utils/checkpoint.py``).  Rounds run one at a time; the reference's
fused round blocks are documented bit-identical to that.

Not ported yet: the device mesh, the detect cache, fcdelta's
``init_labels``/``active_mask``, the batched multi-graph driver.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import warnings
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from fastconsensus_tpu_torch import policy
from fastconsensus_tpu_torch.engine import RoundStats, consensus_round
from fastconsensus_tpu_torch.graph import GraphSlab, grow_slab, pack_edges
from fastconsensus_tpu_torch.models.base import Detector
from fastconsensus_tpu_torch.utils import prng
from fastconsensus_tpu_torch.utils.env import resolve_device

_logger = logging.getLogger("fastconsensus_tpu_torch")

__all__ = ["ConsensusConfig", "ConsensusResult", "RoundStats",
           "run_consensus", "fast_consensus"]


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Run parameters (the reference's fields; see its docstrings)."""

    algorithm: str = "louvain"
    n_p: int = 20
    tau: float = 0.2
    delta: float = 0.02
    max_rounds: int = 64
    seed: int = 0
    gamma: float = 1.0
    auto_grow: bool = True
    warm_start: bool = True
    align_frac: float = 1.0
    closure_sampler: str = "auto"
    closure_tau: Optional[float] = None


class ConsensusResult(NamedTuple):
    partitions: List[np.ndarray]   # n_p final label vectors, compact ids
    graph: GraphSlab               # converged consensus graph
    rounds: int
    converged: bool
    history: List[dict]


def _validate_config(config: ConsensusConfig) -> None:
    if config.closure_sampler not in ("auto", "csr", "scatter"):
        raise ValueError(
            f"closure_sampler={config.closure_sampler!r}: expected "
            f"'auto', 'csr' or 'scatter'")
    if config.closure_tau is not None and \
            not 0.0 <= config.closure_tau <= 1.0:
        raise ValueError(f"closure_tau={config.closure_tau} out of range; "
                         f"allowed values are 0..1 (or None to disable)")
    if not 0.0 <= config.align_frac <= 1.0:
        raise ValueError(f"align_frac={config.align_frac} out of range; "
                         f"allowed values are 0..1")


def _history_entry(stats: RoundStats, rounds: int, capacity: int,
                   n_nodes: int, cold: bool) -> dict:
    """One round's host-side record, as the reference's ``record()``."""
    lc = [int(v) for v in stats.labels_changed.cpu().numpy().ravel()]
    mod = [float(v) for v in stats.member_modularity.cpu().numpy().ravel()]
    n_nodes = max(n_nodes, 1)
    n_front = int(stats.n_frontier)
    return {
        "round": rounds,
        "n_alive": int(stats.n_alive),
        "n_unconverged": int(stats.n_unconverged),
        "n_closure_added": int(stats.n_closure_added),
        "n_repaired": int(stats.n_repaired),
        "n_dropped": int(stats.n_dropped),
        "n_overflow": int(stats.n_overflow),
        "n_hub_overflow": int(stats.n_hub_overflow),
        "n_agg_overflow": int(stats.n_agg_overflow),
        "cold": bool(cold),
        "capacity": capacity,
        "n_w_zero": int(stats.n_w_zero),
        "n_w_full": int(stats.n_w_full),
        "n_frontier": n_front,
        "frontier_frac": round(n_front / n_nodes, 6),
        "labels_changed": int(sum(lc)),
        "labels_changed_by_member": lc,
        "churn_frac": round(sum(lc) / (max(len(lc), 1) * n_nodes), 6),
        "agreement": round(float(stats.agreement), 6),
        "modularity_mean": round(sum(mod) / max(len(mod), 1), 6),
        "modularity_by_member": [round(m, 6) for m in mod],
    }


def _resume_from_checkpoint(path: str, slab: GraphSlab,
                            config: ConsensusConfig, warm: bool,
                            sampler: str):
    """Load and check a checkpoint for :func:`run_consensus`, as the
    reference does: ``(slab, start_round, key, history, labels or None,
    converged, sampler)``.  Rejects a checkpoint written by another run
    configuration (the weights are co-membership counts out of the saved
    n_p), migrates the reference's older formats and grows the slab when
    the caller packed it larger."""
    from fastconsensus_tpu_torch.utils import checkpoint as ckpt

    in_nodes, in_cap = slab.n_nodes, slab.capacity
    in_hyb, in_hub = slab.d_hyb, slab.hub_cap
    slab, start_round, key_data, history, extra = ckpt.load_checkpoint(
        path, device=slab.device)
    if extra.pop("_legacy_v1", False) and (in_hyb or in_hub):
        # v1 files lack the hybrid sizing; it is a function of the input's
        # degrees, so the fresh pack carries the run's own values
        _logger.info("migrating v1 checkpoint: hybrid sizing d_hyb=%d "
                     "hub_cap=%d from the input pack", in_hyb, in_hub)
        slab = dataclasses.replace(slab, d_hyb=in_hyb, hub_cap=in_hub)
    if extra.get("closure_sampler") is None:
        # written before the sampler knob: every such run drew with the
        # scatter sampler, and "auto" keeps drawing with it
        extra["closure_sampler"] = "scatter"
        if config.closure_sampler == "auto":
            _logger.info("checkpoint predates closure_sampler; continuing "
                         "with the scatter sampler it was written with")
            sampler = "scatter"
    extra.pop("_telemetry", None)
    labels = extra.get("_labels") if warm else None
    key = prng.wrap_key_data(key_data, device=slab.device)
    saved = {k: extra.get(k) for k in
             ("algorithm", "n_p", "tau", "delta", "gamma", "warm_start",
              "align_frac", "closure_sampler")}
    # written before the closure_tau knob: such runs inserted with no bar
    ctau_migrated = "closure_tau" not in extra
    extra.setdefault("closure_tau", None)
    if extra["closure_tau"] != config.closure_tau:
        if ctau_migrated:
            raise ValueError(
                f"checkpoint {path} predates the closure_tau knob "
                f"(checkpoint-format migration backfills closure_tau=None: "
                f"such runs inserted with no bar); resuming with "
                f"{config.closure_tau} would mix insert semantics")
        raise ValueError(
            f"checkpoint {path} was written with closure_tau="
            f"{extra['closure_tau']}; resuming with {config.closure_tau} "
            f"would mix insert semantics")
    want = {"algorithm": config.algorithm, "n_p": config.n_p,
            "tau": config.tau, "delta": config.delta, "gamma": config.gamma,
            "warm_start": config.warm_start,
            "align_frac": config.align_frac, "closure_sampler": sampler}
    mismatch = {k: (saved[k], want[k]) for k in want
                if saved[k] is not None and saved[k] != want[k]}
    if slab.n_nodes != in_nodes:
        mismatch["graph"] = (slab.n_nodes, in_nodes)
    elif slab.capacity < in_cap:
        # the caller asked for more room: growth preserves results
        _logger.info("growing resumed slab capacity %d -> %d to honor the "
                     "requested pack size", slab.capacity, in_cap)
        slab = grow_slab(slab, in_cap)
    elif slab.capacity > in_cap:
        _logger.info("resuming with auto-grown slab capacity %d (freshly "
                     "packed: %d)", slab.capacity, in_cap)
    if mismatch:
        raise ValueError(
            f"checkpoint {path} was written by a different run "
            f"configuration: {mismatch} (saved, requested)")
    return (slab, start_round, key, history, labels,
            bool(extra.get("converged", False)), sampler)


def run_consensus(slab: GraphSlab, detect: Detector, config: ConsensusConfig,
                  key: Optional[torch.Tensor] = None,
                  checkpoint_path: Optional[str] = None,
                  checkpoint_every: int = 1,
                  resume: bool = False,
                  on_round=None,
                  n_closure: Optional[int] = None) -> ConsensusResult:
    """Iterate rounds to delta-convergence (or ``max_rounds``), then run the
    final re-detection.  Runs on the slab's device.

    ``checkpoint_path`` persists the state every ``checkpoint_every``
    rounds and on convergence; with ``resume`` an existing checkpoint
    restarts the loop where it stopped (its key, slab, history and labels
    replace the caller's)."""
    dev = slab.device
    if key is None:
        key = prng.key(config.seed, dev)
    key = key.to(dev)
    if n_closure is None:
        n_closure = int(slab.num_alive())   # L := |E0|
    n_closure = int(n_closure)
    _validate_config(config)
    # "auto" is csr: the port has no edge-sharded mesh
    sampler = "csr" if config.closure_sampler == "auto" \
        else config.closure_sampler
    n_p = config.n_p
    warm = config.warm_start and getattr(detect, "supports_init", False)
    align_ok = getattr(detect, "supports_align", False)
    detect_warm = (getattr(detect, "warm_variant", None) or detect) \
        if warm else detect
    detect_refresh = getattr(detect, "refresh_variant", None) or detect

    cur_labels: Optional[torch.Tensor] = None
    if resume and checkpoint_path is not None and \
            os.path.exists(checkpoint_path):
        (slab, start_round, key, prior_history, cur_labels,
         resumed_converged, sampler) = _resume_from_checkpoint(
            checkpoint_path, slab, config, warm, sampler)
    else:
        start_round = 0
        prior_history = []
        resumed_converged = False
        # weights <- 1.0 at loop start (fc:135-136)
        slab = slab.with_weights(torch.where(slab.alive, 1.0, 0.0))

    history: List[dict] = list(prior_history)
    pstate = policy.state_from_history(history)
    budget_noop = None
    converged = resumed_converged
    rounds = start_round
    end_round = start_round if resumed_converged else config.max_rounds
    # the round that starts from singletons runs the full-sweep detector:
    # round 0, or the first resumed round of a checkpoint without labels
    cold_start_round = start_round if cur_labels is None else -1
    sing = torch.arange(slab.n_nodes, device=dev).expand(n_p, slab.n_nodes)
    if warm and cur_labels is None:
        cur_labels = sing
    prev_round_labels = sing

    def round_mode(r0: int) -> str:
        if not warm or r0 == cold_start_round:
            return "cold"
        if bool(policy.stale(np, config.delta, pstate)):
            _logger.warning("warm limit cycle: round %d re-detects cold", r0)
            return "refresh"
        if bool(policy.stalled(np, config.delta, pstate, align_now(r0))):
            _logger.warning("warm stagnation (unconverged %d -> %d): round "
                            "%d re-detects cold", int(pstate.u2),
                            int(pstate.u1), r0)
            return "refresh"
        return "warm"

    def align_now(r0: int) -> bool:
        if not (warm and align_ok and config.align_frac > 0 and history):
            return False
        if r0 == cold_start_round:
            return False
        return bool(policy.align_now(np, config.align_frac, pstate))

    def maybe_regrow_budgets() -> None:
        nonlocal slab, budget_noop
        if not config.auto_grow or not history:
            return
        h = history[-1]
        if budget_noop is not None and \
                h["n_overflow"] <= budget_noop[0] and \
                h["n_hub_overflow"] <= budget_noop[1] and \
                h["n_alive"] <= budget_noop[2]:
            return
        if not bool(policy.budgets_stale(
                np, h["n_overflow"], h["n_hub_overflow"], slab.d_cap,
                slab.hub_cap, slab.n_nodes, h["n_alive"], slab.agg_cap)):
            return
        from fastconsensus_tpu_torch.graph import (derive_agg_sizing,
                                                   derive_dense_sizing,
                                                   derive_hybrid_sizing)

        deg = slab.degrees().cpu().numpy().astype(np.int64)
        n_alive = int(slab.num_alive())
        new_d_cap = derive_dense_sizing(deg, slab.n_nodes)
        new_hyb, new_hub = derive_hybrid_sizing(deg, slab.n_nodes, n_alive)
        new_agg = derive_agg_sizing(n_alive) if slab.agg_cap > 0 else 0
        if (new_d_cap, new_hyb, new_hub, new_agg) == \
                (slab.d_cap, slab.d_hyb, slab.hub_cap, slab.agg_cap):
            budget_noop = (h["n_overflow"], h["n_hub_overflow"],
                           (5 * slab.agg_cap) // 4 if slab.agg_cap > 0
                           else 2 ** 31 - 1)
            return
        budget_noop = None
        _logger.warning(
            "move-candidate budgets starved (overflow %d dense / %d hub, "
            "%d alive): re-deriving d_cap %d -> %d, d_hyb %d -> %d, "
            "hub_cap %d -> %d, agg_cap %d -> %d", h["n_overflow"],
            h["n_hub_overflow"], h["n_alive"], slab.d_cap, new_d_cap,
            slab.d_hyb, new_hyb, slab.hub_cap, new_hub, slab.agg_cap,
            new_agg)
        slab = dataclasses.replace(slab, d_cap=new_d_cap, d_hyb=new_hyb,
                                   hub_cap=new_hub, agg_cap=new_agg)

    r = start_round
    while r < end_round:
        maybe_regrow_budgets()
        pre_slab = slab
        k = prng.stream(key, prng.STREAM_ROUND, r)
        mode = round_mode(r)
        is_cold = mode != "warm"
        round_detect = {"cold": detect, "refresh": detect_refresh,
                        "warm": detect_warm}[mode]
        if warm:
            slab_new, new_labels, stats = consensus_round(
                slab, k, round_detect, n_p, config.tau, config.delta,
                n_closure, init_labels=sing if is_cold else cur_labels,
                align=align_now(r) and not is_cold,
                closure_tau=config.closure_tau, prev_labels=cur_labels,
                sampler=sampler)
        else:
            slab_new, new_labels, stats = consensus_round(
                slab, k, round_detect, n_p, config.tau, config.delta,
                n_closure, closure_tau=config.closure_tau,
                prev_labels=prev_round_labels, sampler=sampler)
        dropped = int(stats.n_dropped)
        if config.auto_grow and dropped > 0:
            # grow from the pre-round state and replay the round: same key,
            # same slot-fill order, so only the dropped survivors change
            new_cap = pre_slab.capacity + max(2 * dropped,
                                              pre_slab.capacity // 2)
            _logger.warning(
                "edge slab saturated (%d survivors dropped); growing "
                "capacity %d -> %d and replaying the round", dropped,
                pre_slab.capacity, new_cap)
            slab = grow_slab(pre_slab, new_cap)
            continue
        slab = slab_new
        if warm:
            cur_labels = new_labels
        prev_round_labels = new_labels
        r += 1
        rounds += 1
        entry = _history_entry(stats, rounds, slab.capacity, slab.n_nodes,
                               is_cold)
        history.append(entry)
        pstate = policy.observe(np, pstate, np.bool_(entry["cold"]),
                                np.int32(entry["n_unconverged"]),
                                np.int32(entry["n_alive"]))
        if on_round is not None:
            on_round(entry)
        converged = bool(stats.converged)
        if checkpoint_path is not None and \
                (rounds % checkpoint_every == 0 or converged):
            from fastconsensus_tpu_torch.utils import checkpoint as ckpt

            ckpt.save_checkpoint(
                checkpoint_path, slab, rounds, prng.key_data(key), history,
                extra={"algorithm": config.algorithm, "n_p": n_p,
                       "tau": config.tau, "delta": config.delta,
                       "gamma": config.gamma,
                       "warm_start": config.warm_start,
                       "align_frac": config.align_frac,
                       "closure_sampler": sampler,
                       "closure_tau": config.closure_tau,
                       # the port sizes member chunks from memory alone
                       "member_seconds": None,
                       "converged": converged},
                labels=cur_labels if warm else None)
        if converged:
            break

    maybe_regrow_budgets()
    final_keys = prng.partition_keys(
        prng.stream(key, prng.STREAM_FINAL), n_p)
    # the warm variant only when the seed labels come from real detection
    final_detect = detect_warm if (
        warm and (cold_start_round == -1 or rounds > start_round)) \
        else detect
    final_labels = final_detect(slab, final_keys,
                                cur_labels if warm else None)
    all_labels = final_labels.cpu().numpy().astype(np.int32)
    return ConsensusResult(partitions=[all_labels[i] for i in range(n_p)],
                           graph=slab, rounds=rounds, converged=converged,
                           history=history)


def fast_consensus(edges: np.ndarray, n_nodes: int,
                   algorithm: str = "louvain", n_p: int = 20,
                   tau: float = 0.2, delta: float = 0.02, seed: int = 0,
                   max_rounds: int = 64, gamma: float = 1.0,
                   device=None, capacity: Optional[int] = None,
                   **config) -> ConsensusResult:
    """Edges in, partitions out (the reference's convenience API).  Runs
    on CUDA unless ``device`` names another device.  ``capacity`` sizes
    the slab (default ``2*E + 16``); other :class:`ConsensusConfig` fields
    (``auto_grow``, ``warm_start``, ``align_frac``, ``closure_sampler``,
    ``closure_tau``) pass through.  A ``gamma`` the detector does not take
    is ignored with a warning and reset to 1.0, as the CLI does."""
    from fastconsensus_tpu_torch.models.registry import (get_detector,
                                                         supports_param)

    dev = resolve_device(device)
    slab = pack_edges(edges, n_nodes, capacity=capacity, device=dev)
    if gamma != 1.0 and not supports_param(algorithm, "gamma"):
        warnings.warn(
            f"gamma={gamma} ignored for algorithm={algorithm!r} (resolution "
            f"applies to modularity detectors)", stacklevel=2)
        gamma = 1.0
    cfg = ConsensusConfig(algorithm=algorithm, n_p=n_p, tau=tau, delta=delta,
                          seed=seed, max_rounds=max_rounds, gamma=gamma,
                          **config)
    return run_consensus(slab, get_detector(algorithm, gamma=gamma), cfg)
