"""The consensus driver: iterate rounds to delta-convergence, then re-detect.

Counterpart of the solo ``run_consensus`` of ``fastconsensus_tpu/
consensus.py``, with everything that changes results kept: warm-started
detection (capped-sweep warm variant), endgame key alignment, stagnation
refresh (policy.stale / policy.stalled), re-derivation of the dense/hybrid
budgets when they starve (policy.budgets_stale), auto-growth of the slab
with a deterministic replay of the saturating round, both wedge samplers,
and checkpoint/resume in the reference's file format
(``utils/checkpoint.py``), and fcdelta's incremental re-consensus from a
parent run's partitions (``init_labels`` / ``active_mask``).  Rounds run
one at a time; the reference's fused round blocks are documented
bit-identical to that.  :func:`run_consensus_batch` runs B same-bucket
graphs as one member-batched detection stream, each job's result its
solo run's.  With ``detect_cache_dir`` every round's detection and the
final re-detection run in driver chunks persisted as they finish, so a
killed run restarts within the round it died in.  fcobs spans and
counters (``obs/``) mark the same places as the reference's.

Not ported yet: the device mesh.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from fastconsensus_tpu_torch import policy, sizing
from fastconsensus_tpu_torch.engine import (RoundStats, _detect_chunked,
                                            consensus_batch_round,
                                            consensus_round, detect_stacked,
                                            stats_to_host)
from fastconsensus_tpu_torch.graph import (GraphSlab, check_stackable,
                                           grow_slab, pack_edges,
                                           stack_slabs)
from fastconsensus_tpu_torch.models.base import Detector
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs.tracer import get_tracer
from fastconsensus_tpu_torch.utils import prng
from fastconsensus_tpu_torch.utils.env import env_int, resolve_device

_logger = logging.getLogger("fastconsensus_tpu_torch")

__all__ = ["ConsensusConfig", "ConsensusResult", "RoundStats",
           "BatchResults", "run_consensus", "run_consensus_batch",
           "fast_consensus"]


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
    """One round's host-side record, as the reference's ``record()``, from
    stats on the host (:func:`engine.stats_to_host`)."""
    lc = [int(v) for v in np.asarray(stats.labels_changed).ravel()]
    mod = [float(v) for v in np.asarray(stats.member_modularity).ravel()]
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
    converged, sampler, saved_counters)``.  Rejects a checkpoint written
    by another run configuration (the weights are co-membership counts
    out of the saved n_p), migrates the reference's older formats and
    grows the slab when the caller packed it larger.  The checkpoint's
    fcobs counters (``{}`` when it has none) are restored into the
    registry by delta once every check has passed, and handed back so
    later checkpoints persist them plus this process's increments."""
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
    saved_counters = extra.pop("_telemetry", None) or {}
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
    if saved_counters:
        # only after every check: a rejected resume leaks no counts
        reg = obs_counters.get_registry()
        applied = reg.restore_counters(saved_counters)
        if applied:
            _logger.info("restored %d fcobs counter(s) from checkpoint "
                         "telemetry (rounds.total now %d)", len(applied),
                         reg.counters().get("rounds.total", 0))
    return (slab, start_round, key, history, labels,
            bool(extra.get("converged", False)), sampler, saved_counters)


class _JobPolicy:
    """One job's per-round decisions, taken alike by :func:`run_consensus`
    and :func:`run_consensus_batch`: the next round's mode, endgame key
    alignment and the re-derivation of starving move-candidate budgets.
    It holds the job's history (appended by :meth:`observe`) and its
    policy state."""

    def __init__(self, config: ConsensusConfig, detect: Detector,
                 warm: bool, cold_start_round: int, history: List[dict]):
        self.config = config
        self.warm = warm
        self.align_ok = getattr(detect, "supports_align", False)
        self.cold_start_round = cold_start_round
        self.history = history
        self.pstate = policy.state_from_history(history)
        self.budget_noop = None

    def observe(self, entry: dict) -> None:
        self.history.append(entry)
        self.pstate = policy.observe(
            np, self.pstate, np.bool_(entry["cold"]),
            np.int32(entry["n_unconverged"]), np.int32(entry["n_alive"]))

    def align(self, r: int) -> bool:
        """Does round ``r`` share one detection key across members?"""
        if not (self.warm and self.align_ok and self.config.align_frac > 0
                and self.history) or r == self.cold_start_round:
            return False
        return bool(policy.align_now(np, self.config.align_frac,
                                     self.pstate))

    def mode(self, r: int) -> str:
        """Round ``r``'s detection: "cold" (from singletons), "refresh"
        (a stagnation re-detection from singletons) or "warm"."""
        if not self.warm or r == self.cold_start_round:
            return "cold"
        delta = self.config.delta
        if bool(policy.stale(np, delta, self.pstate)):
            _logger.warning("warm limit cycle: round %d re-detects cold", r)
            return "refresh"
        if bool(policy.stalled(np, delta, self.pstate, self.align(r))):
            _logger.warning("warm stagnation (unconverged %d -> %d): round "
                            "%d re-detects cold", int(self.pstate.u2),
                            int(self.pstate.u1), r)
            return "refresh"
        return "warm"

    def regrow_budgets(self, slab: GraphSlab) -> GraphSlab:
        """Before a round and before the final re-detection: ``slab`` with
        its dense/hybrid/aggregate budgets re-derived from the live degrees
        when the last round starved them, else ``slab`` itself."""
        if not self.config.auto_grow or not self.history:
            return slab
        h = self.history[-1]
        noop = self.budget_noop
        if noop is not None and h["n_overflow"] <= noop[0] and \
                h["n_hub_overflow"] <= noop[1] and h["n_alive"] <= noop[2]:
            return slab
        if not bool(policy.budgets_stale(
                np, h["n_overflow"], h["n_hub_overflow"], slab.d_cap,
                slab.hub_cap, slab.n_nodes, h["n_alive"], slab.agg_cap)):
            return slab
        from fastconsensus_tpu_torch.graph import (derive_agg_sizing,
                                                   derive_dense_sizing,
                                                   derive_hybrid_sizing)

        deg = slab.degrees().cpu().numpy().astype(np.int64)
        n_alive = int(slab.num_alive())
        obs_counters.host_sync("budget_histogram", 2)
        new_d_cap = derive_dense_sizing(deg, slab.n_nodes)
        new_hyb, new_hub = derive_hybrid_sizing(deg, slab.n_nodes, n_alive)
        new_agg = derive_agg_sizing(n_alive) if slab.agg_cap > 0 else 0
        if (new_d_cap, new_hyb, new_hub, new_agg) == \
                (slab.d_cap, slab.d_hyb, slab.hub_cap, slab.agg_cap):
            self.budget_noop = (h["n_overflow"], h["n_hub_overflow"],
                                (5 * slab.agg_cap) // 4 if slab.agg_cap > 0
                                else 2 ** 31 - 1)
            return slab
        self.budget_noop = None
        _logger.warning(
            "move-candidate budgets starved (overflow %d dense / %d hub, "
            "%d alive): re-deriving d_cap %d -> %d, d_hyb %d -> %d, "
            "hub_cap %d -> %d, agg_cap %d -> %d", h["n_overflow"],
            h["n_hub_overflow"], h["n_alive"], slab.d_cap, new_d_cap,
            slab.d_hyb, new_hyb, slab.hub_cap, new_hub, slab.agg_cap,
            new_agg)
        obs_counters.get_registry().inc("budgets.rederive_events")
        return dataclasses.replace(slab, d_cap=new_d_cap, d_hyb=new_hyb,
                                   hub_cap=new_hub, agg_cap=new_agg)


def _cache_fingerprint(config: ConsensusConfig, slab: GraphSlab,
                       warm: bool, sampler: str) -> str:
    """The reference's detect-cache fingerprint of a run: the settings
    that change its labels and the slab's statics that select the
    lowering (not the live capacity: labels do not depend on it, so an
    auto-grow replay keeps its round's chunks).  The reference also
    hashes its mesh's shape; the port has no mesh (``None``)."""
    return hashlib.sha1(repr(
        (config.algorithm, config.n_p, config.tau, config.delta,
         config.seed, config.max_rounds, slab.n_nodes,
         slab.cap_hint or slab.capacity, slab.agg_cap, slab.d_cap,
         slab.d_hyb, slab.hub_cap, config.gamma, warm, config.align_frac,
         sampler, config.closure_tau, None)).encode()).hexdigest()[:10]


def run_consensus(slab: GraphSlab, detect: Detector, config: ConsensusConfig,
                  key: Optional[torch.Tensor] = None,
                  checkpoint_path: Optional[str] = None,
                  checkpoint_every: int = 1,
                  resume: bool = False,
                  on_round=None,
                  detect_cache_dir: Optional[str] = None,
                  n_closure: Optional[int] = None,
                  init_labels=None,
                  active_mask=None) -> ConsensusResult:
    """Iterate rounds to delta-convergence (or ``max_rounds``), then run the
    final re-detection.  Runs on the slab's device.

    ``checkpoint_path`` persists the state every ``checkpoint_every``
    rounds and on convergence; with ``resume`` an existing checkpoint
    restarts the loop where it stopped (its key, slab, history, labels
    and fcobs counters replace the caller's).

    ``detect_cache_dir``: elastic recovery within a round.  Every round's
    detection and the final re-detection run in driver chunks of
    ``members`` keys (``FCTPU_DETECT_CALL_MEMBERS``; else the chunking a
    killed process recorded in the dir's ``sizing.json``, if its
    fingerprint matches; else ``sizing.members_per_call`` for the
    detector), each persisted as it finishes (``engine._detect_chunked``,
    tagged with a fingerprint of the run and the round), so a restarted
    process (same config and seed, ``resume`` with a checkpoint for the
    round state) detects only the chunks still missing.  Clean the dir
    between unrelated runs.

    ``init_labels`` / ``active_mask`` (fcdelta, ``serve/delta.py``): seed
    the run from a prior run's final partitions (``init_labels``
    ``[n_p, n_nodes]``) instead of singletons, so round 0 runs the
    capped-sweep warm detector, and optionally freeze the vertices outside
    ``active_mask`` (bool[n_nodes]) at their ``init_labels`` through every
    round and the final re-detection (a clamp on the host).  Stagnation
    refreshes still re-detect cold.  Requires a warm-capable detector
    (``warm_start`` on and ``supports_init``); incompatible with
    checkpoint/resume.

    fcobs: spans on the ambient tracer (a shared no-op unless a caller
    set one, so the hooks cost attribute checks) and counters on the
    process registry, at the reference's places."""
    dev = slab.device
    tracer = get_tracer()
    obs_reg = obs_counters.get_registry()
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
    if active_mask is not None and init_labels is None:
        raise ValueError("active_mask requires init_labels (the frozen "
                         "vertices' labels come from the parent run)")
    if init_labels is not None:
        if not warm:
            raise ValueError(
                "init_labels requires warm_start=True and a detector "
                "with supports_init (the warm ensemble IS the reuse)")
        if checkpoint_path is not None or resume:
            raise ValueError("init_labels is incompatible with "
                             "checkpoint/resume (two competing notions "
                             "of 'where the run starts')")
        init_labels = np.asarray(init_labels, np.int32)
        if init_labels.shape != (config.n_p, slab.n_nodes):
            raise ValueError(
                f"init_labels shape {init_labels.shape} != "
                f"{(config.n_p, slab.n_nodes)} (n_p, n_nodes)")
    active_np: Optional[np.ndarray] = None
    active = None
    if active_mask is not None:
        active_np = np.asarray(active_mask, bool)
        if active_np.shape != (slab.n_nodes,):
            raise ValueError(f"active_mask shape {active_np.shape} != "
                             f"({slab.n_nodes},)")
        active = torch.as_tensor(active_np, device=dev)
    detect_warm = (getattr(detect, "warm_variant", None) or detect) \
        if warm else detect
    detect_refresh = getattr(detect, "refresh_variant", None) or detect

    cur_labels: Optional[torch.Tensor] = None
    saved_counters: Dict[str, int] = {}
    if resume and checkpoint_path is not None and \
            os.path.exists(checkpoint_path):
        (slab, start_round, key, prior_history, cur_labels,
         resumed_converged, sampler, saved_counters) = \
            _resume_from_checkpoint(checkpoint_path, slab, config, warm,
                                    sampler)
    else:
        start_round = 0
        prior_history = []
        resumed_converged = False
        # weights <- 1.0 at loop start (fc:135-136)
        slab = slab.with_weights(torch.where(slab.alive, 1.0, 0.0))
    if init_labels is not None:
        # the run begins where the parent ended, as a labels-bearing
        # resume does: round 0 runs the warm detector
        cur_labels = torch.as_tensor(init_labels.astype(np.int64),
                                     device=dev)
    # run-scoped telemetry (after any restore): a checkpoint persists the
    # restored counters plus this run's increments, never counts an
    # earlier run left in the process registry
    obs_base = obs_reg.counters()

    def run_telemetry() -> Dict[str, int]:
        out = dict(saved_counters)
        for k, v in obs_reg.counters_since(obs_base).items():
            out[k] = out.get(k, 0) + v
        return out

    members = n_p
    cache_fp = ""
    first_setup = True

    def setup_cache() -> None:
        """The detect cache's fingerprint and driver chunk size, from the
        slab's statics: at the start and after a budget re-derivation."""
        nonlocal members, cache_fp, first_setup
        os.makedirs(detect_cache_dir, exist_ok=True)
        fp_base = _cache_fingerprint(config, slab, warm, sampler)
        pinned = env_int("FCTPU_DETECT_CALL_MEMBERS")
        prev = sizing.read_sizing(detect_cache_dir) \
            if first_setup and pinned is None else None
        if pinned is not None:
            members = n_p if pinned <= 0 else min(pinned, n_p)
        elif prev is not None and prev.get("fp") == fp_base:
            # a restart adopts the killed run's chunking, whatever its
            # own sizing says, or the round's persisted chunks orphan
            members = int(prev["members"])
        else:
            members = sizing.members_per_call(
                slab, n_p, getattr(detect, "member_bytes", None))
        cache_fp = hashlib.sha1(repr((fp_base, members)).encode()
                                ).hexdigest()[:10]
        sizing.write_sizing(detect_cache_dir, fp_base, members)
        first_setup = False

    def regrow_budgets() -> None:
        """Re-derive starved budgets (``_JobPolicy.regrow_budgets``); new
        statics re-derive the cache fingerprint too."""
        nonlocal slab
        regrown = job.regrow_budgets(slab)
        if regrown is not slab:
            slab = regrown
            if detect_cache_dir:
                setup_cache()

    def chunked(det: Detector, tag: str) -> Detector:
        """``det`` through the persisted driver chunks of ``tag``."""
        return lambda s, ks, init=None: _detect_chunked(
            det, s, ks, members, cache_dir=detect_cache_dir,
            cache_tag=f"{cache_fp}_{tag}", init_labels=init)

    history: List[dict] = list(prior_history)
    converged = resumed_converged
    rounds = start_round
    end_round = start_round if resumed_converged else config.max_rounds
    # the round that starts from singletons runs the full-sweep detector:
    # round 0, or the first resumed round of a checkpoint without labels
    cold_start_round = start_round if cur_labels is None else -1
    job = _JobPolicy(config, detect, warm, cold_start_round, history)
    sing = torch.arange(slab.n_nodes, device=dev).expand(n_p, slab.n_nodes)
    if warm and cur_labels is None:
        cur_labels = sing
    prev_round_labels = sing
    if detect_cache_dir:
        setup_cache()

    r = start_round
    while r < end_round:
        t_iter = time.perf_counter()
        regrow_budgets()
        pre_slab = slab
        k = prng.stream(key, prng.STREAM_ROUND, r)
        mode = job.mode(r)
        is_cold = mode != "warm"
        round_detect = {"cold": detect, "refresh": detect_refresh,
                        "warm": detect_warm}[mode]
        if detect_cache_dir:
            round_detect = chunked(round_detect, f"r{r}")
        with tracer.step_span("round", r, mode=mode):
            if warm:
                slab_new, new_labels, stats = consensus_round(
                    slab, k, round_detect, n_p, config.tau, config.delta,
                    n_closure, init_labels=sing if is_cold else cur_labels,
                    align=job.align(r) and not is_cold,
                    closure_tau=config.closure_tau, prev_labels=cur_labels,
                    sampler=sampler, active=active)
            else:
                slab_new, new_labels, stats = consensus_round(
                    slab, k, round_detect, n_p, config.tau, config.delta,
                    n_closure, closure_tau=config.closure_tau,
                    prev_labels=prev_round_labels, sampler=sampler)
            stats = stats_to_host([stats])[0]
        obs_counters.host_sync("round_stats")
        dropped = int(stats.n_dropped)
        if config.auto_grow and dropped > 0:
            # grow from the pre-round state and replay the round: same key,
            # same slot-fill order, so only the dropped survivors change
            with tracer.span("grow_and_replay", dropped=dropped):
                obs_reg.inc("slab.regrow_events")
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
        job.observe(entry)
        obs_counters.fold_round(entry)
        if on_round is not None:
            on_round(entry)
        obs_reg.observe("round.seconds", time.perf_counter() - t_iter)
        converged = bool(stats.converged)
        if checkpoint_path is not None and \
                (rounds % checkpoint_every == 0 or converged):
            from fastconsensus_tpu_torch.utils import checkpoint as ckpt

            with tracer.span("checkpoint", round=rounds):
                # key data and, when warm, the labels are read back
                obs_counters.host_sync("checkpoint", 2 if warm else 1)
                ckpt.save_checkpoint(
                    checkpoint_path, slab, rounds, prng.key_data(key),
                    history,
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
                    labels=cur_labels if warm else None,
                    telemetry=run_telemetry())
        if converged:
            break

    regrow_budgets()
    final_keys = prng.partition_keys(
        prng.stream(key, prng.STREAM_FINAL), n_p)
    # the warm variant only when the seed labels come from real detection
    final_detect = detect_warm if (
        warm and (cold_start_round == -1 or rounds > start_round)) \
        else detect
    if detect_cache_dir:
        final_detect = chunked(final_detect, "final")
    with tracer.span("final_detect"):
        final_labels = final_detect(slab, final_keys,
                                    cur_labels if warm else None)
        all_labels = final_labels.cpu().numpy().astype(np.int32)
    obs_counters.host_sync("final_labels")
    partitions = [all_labels[i] for i in range(n_p)]
    if active_np is not None:
        # frozen vertices keep the parent's labels through the final
        # re-detection too
        partitions = [np.where(active_np, p, init_labels[i])
                      for i, p in enumerate(partitions)]
    return ConsensusResult(partitions=partitions, graph=slab, rounds=rounds,
                           converged=converged, history=history)


class BatchResults(list):
    """The :class:`ConsensusResult` of each job of a
    :func:`run_consensus_batch` call, in order.  ``splits`` maps each job
    that split off the batch and re-ran alone to the reason (empty when
    every job stayed batched)."""

    splits: Dict[int, str]


def run_consensus_batch(slabs: List[GraphSlab], detect: Detector,
                        config: ConsensusConfig, n_closure: int,
                        seeds=None, keys=None) -> BatchResults:
    """Run B independent same-bucket consensus jobs as one batched round
    stream, the batch counterpart of :func:`run_consensus` (the serving
    tier's coalescing path).  Runs on the slabs' device.

    Each batched round detects the members of all the jobs it runs as one
    member-batched stream (``engine.consensus_batch_round``; detectors
    without ``supports_stack``, the host C++ ones, run once per job) and
    reads back one stack of stats.  **Bit-parity contract**: every job's
    partitions, rounds, convergence and history are those of running it
    alone through :func:`run_consensus` with its own key.  Round keys
    derive from ``(key_b, round_b)`` as :func:`run_consensus`'s, and each
    job's round decisions are the solo driver's own (``_JobPolicy``):
    round 0 is uniformly cold; stagnation refreshes run batched through
    the cold mode with the refresh variant, masked to the jobs whose
    policy fired; warm rounds run batched; converged jobs drop out.  A job
    whose round drops edges (under ``auto_grow``) or whose budgets are
    re-derived (a change of its statics) is **split off**: its batched
    progress is discarded and it re-runs alone through
    :func:`run_consensus`.  The final re-detection is batched, with
    per-job ``STREAM_FINAL`` keys; it runs the warm variant once a round
    has run, the solo driver's rule (the reference's batch driver runs it
    under warm start even at ``max_rounds=0``, where its solo driver does
    not), so that every job equals its solo run.

    ``n_closure`` is required: the bucket-canonical L
    (``serve/bucketer.Bucket.n_closure``) shared by the batch.  ``seeds``
    gives job b the run key ``prng.key(seeds[b])`` (default
    ``config.seed`` for every job); ``keys`` passes run keys instead.  No
    checkpoint/resume, no fcdelta masks.  The split count is logged on the
    ``fastconsensus_tpu_torch`` logger; ``BatchResults.splits`` maps each
    split job to the reason.
    """
    B = len(slabs)
    if B < 1:
        raise ValueError("run_consensus_batch needs at least one slab")
    tracer = get_tracer()
    obs_reg = obs_counters.get_registry()
    if keys is not None and seeds is not None:
        raise ValueError("pass seeds or keys, not both")
    check_stackable(slabs)
    dev = slabs[0].device
    if keys is None:
        seeds = list(seeds) if seeds is not None else [config.seed] * B
        if len(seeds) != B:
            raise ValueError(f"{len(seeds)} seeds for {B} slabs")
        keys = [prng.key(int(s), dev) for s in seeds]
    keys = [k.to(dev) for k in keys]
    if len(keys) != B:
        raise ValueError(f"{len(keys)} keys for {B} slabs")
    _validate_config(config)
    sampler = "csr" if config.closure_sampler == "auto" \
        else config.closure_sampler
    n_closure = int(n_closure)
    warm = config.warm_start and getattr(detect, "supports_init", False)
    detect_warm = (getattr(detect, "warm_variant", None) or detect) \
        if warm else detect
    detect_refresh = getattr(detect, "refresh_variant", None) or detect

    n_nodes, n_p = slabs[0].n_nodes, config.n_p
    # weights <- 1.0 at loop start, per job (run_consensus parity)
    cur = [s.with_weights(torch.where(s.alive, 1.0, 0.0)) for s in slabs]
    sing = torch.arange(n_nodes, device=dev).expand(n_p, n_nodes)
    # the singleton baseline is every job's round-0 churn baseline, also
    # without warm start (run_consensus's prev_round_labels)
    labels = [sing] * B
    jobs = [_JobPolicy(config, detect, warm, 0, []) for _ in range(B)]
    conv = np.zeros(B, bool)
    rounds = np.zeros(B, np.int64)
    solo = np.zeros(B, bool)
    results = BatchResults([None] * B)
    results.splits = {}

    def split_off(i: int, why: str) -> None:
        solo[i] = True
        results.splits[i] = why
        obs_reg.inc("batch.solo_splits")
        _logger.info("batch job %d split off to solo tail (%s)", i, why)

    def active() -> np.ndarray:
        return ~conv & ~solo & (rounds < config.max_rounds)

    def run_round(mode: str, det: Detector, only=None) -> None:
        mask = active() if only is None else active() & only
        idx = [int(i) for i in np.flatnonzero(mask)]
        if not idx:
            return
        init = None
        if mode == "warm":
            init = [labels[i] for i in idx]
        elif mode == "cold":
            init = [sing] * len(idx)
        with tracer.step_span("batch_block", int(rounds[idx].min()), b=B,
                              mode=mode):
            out = consensus_batch_round(
                [cur[i] for i in idx],
                [prng.stream(keys[i], prng.STREAM_ROUND, int(rounds[i]))
                 for i in idx],
                det, n_p, config.tau, config.delta, n_closure, init,
                [mode == "warm" and jobs[i].align(int(rounds[i]))
                 for i in idx],
                [labels[i] for i in idx], closure_tau=config.closure_tau,
                sampler=sampler)
            # one readback of the whole batch's stats
            host = stats_to_host([st for _, _, st in out])
        obs_counters.host_sync("batch_block_stats")
        obs_reg.inc("batch.blocks")
        for i, (slab_new, lab, _), st in zip(idx, out, host):
            if config.auto_grow and int(st.n_dropped) > 0:
                # run_consensus would grow the slab and replay
                split_off(i, f"slab saturated at round {rounds[i]}")
                continue
            rounds[i] += 1
            jobs[i].observe(_history_entry(st, int(rounds[i]),
                                           slab_new.capacity, n_nodes,
                                           mode != "warm"))
            conv[i] = bool(st.converged)
            cur[i], labels[i] = slab_new, lab
            # run_consensus re-derives starved budgets before its next
            # round and its final re-detection: new statics leave the
            # bucket
            if jobs[i].regrow_budgets(slab_new) is not slab_new:
                split_off(i, f"budget re-derivation after round "
                             f"{rounds[i]}")

    if warm:
        # absolute round 0: uniformly cold (singleton-init full sweeps)
        run_round("cold", detect)
        while active().any():
            refresh = np.array([bool(a) and
                                jobs[i].mode(int(rounds[i])) == "refresh"
                                for i, a in enumerate(active())])
            if refresh.any():
                obs_reg.inc("batch.refresh_rounds", int(refresh.sum()))
                run_round("cold", detect_refresh, only=refresh)
                continue
            run_round("warm", detect_warm)
    else:
        while active().any():
            run_round("scratch", detect)

    batched = [i for i in range(B) if not solo[i]]
    if batched:
        final_keys = torch.cat([prng.partition_keys(
            prng.stream(keys[i], prng.STREAM_FINAL), n_p) for i in batched])
        # run_consensus's rule: the warm variant once a round has run
        final_warm = warm and config.max_rounds > 0
        with tracer.span("batch_final_detect", b=B):
            final = detect_stacked(
                detect_warm if final_warm else detect,
                stack_slabs([cur[i] for i in batched]), final_keys,
                torch.cat([labels[i] for i in batched]) if warm else None)
            all_labels = final.cpu().numpy().astype(np.int32)
        obs_counters.host_sync("batch_final_labels")
        for j, i in enumerate(batched):
            # folded here, not per round: a job split off discards its
            # batched rounds and its solo rerun folds its own
            for entry in jobs[i].history:
                obs_counters.fold_round(entry)
            results[i] = ConsensusResult(
                partitions=[all_labels[j * n_p + p] for p in range(n_p)],
                graph=cur[i], rounds=int(rounds[i]),
                converged=bool(conv[i]), history=jobs[i].history)
    if results.splits:
        _logger.info("batch of %d: %d job(s) split off to solo runs: %s",
                     B, len(results.splits), sorted(results.splits))
    for i in sorted(results.splits):
        # the parity reference itself: the job alone with its own key
        results[i] = run_consensus(slabs[i], detect, config, key=keys[i],
                                   n_closure=n_closure)
    return results


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
