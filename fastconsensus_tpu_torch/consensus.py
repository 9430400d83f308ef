"""The consensus driver: iterate rounds to delta-convergence, then re-detect.

Counterpart of the solo ``run_consensus`` of ``fastconsensus_tpu/
consensus.py``, with everything that changes results kept: warm-started
detection (capped-sweep warm variant), endgame key alignment, stagnation
refresh (policy.stale / policy.stalled), re-derivation of the dense/hybrid
budgets when they starve (policy.budgets_stale), auto-growth of the slab
with a deterministic replay of the saturating round, both wedge samplers,
and checkpoint/resume in the reference's file format
(``utils/checkpoint.py``), and fcdelta's incremental re-consensus from a
parent run's partitions (``init_labels`` / ``active_mask``).  Where the
reference fuses rounds (one call a round, no checkpoint, no mesh, and
here no detect cache) every detector's rounds run in fused blocks when
FCTPU_ROUNDS_BLOCK asks for them (``engine.RoundsBlock``: a captured CUDA
graph on the card, one stats readback a block; CNM's and Infomap's host
C++ runs in it as a host node), bit for bit one round a host step.
:func:`run_consensus_batch` runs B same-bucket graphs as one
member-batched detection stream, each job's result its solo run's, its
rounds in batched blocks alike (``engine.BatchBlock``).  With ``detect_cache_dir`` every round's
detection and the final re-detection run in driver chunks persisted as
they finish, so a
killed run restarts within the round it died in.  fcobs spans and
counters (``obs/``) mark the same places as the reference's.  With a
device mesh (``run_consensus(mesh=)``, ``parallel/``) the ensemble splits
over its "p" axis and the slab over its "e" axis, bit for bit the
unsharded run with the scatter sampler.
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
from fastconsensus_tpu_torch.engine import (BLOCK_MAX, BatchBlock,
                                            RoundsBlock, RoundStats,
                                            _detect_chunked,
                                            consensus_batch_round,
                                            consensus_round, detect_stacked,
                                            stats_to_host)
from fastconsensus_tpu_torch.graph import (GraphSlab, _statics,
                                           check_stackable, grow_slab,
                                           pack_edges, stack_slabs)
from fastconsensus_tpu_torch.models.base import Detector
from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs.tracer import get_tracer, traced
from fastconsensus_tpu_torch.parallel.sharding import (ENSEMBLE_AXIS, Mesh,
                                                       ShardedSlab,
                                                       gather_labels,
                                                       gather_slab,
                                                       shard_labels,
                                                       shard_slab)
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
        return slab.with_statics(d_cap=new_d_cap, d_hyb=new_hyb,
                                 hub_cap=new_hub, agg_cap=new_agg)


def _cache_fingerprint(config: ConsensusConfig, slab: GraphSlab,
                       warm: bool, sampler: str, mesh=None) -> str:
    """The reference's detect-cache fingerprint of a run: the settings
    that change its labels, the slab's statics that select the lowering
    (not the live capacity: labels do not depend on it, so an auto-grow
    replay keeps its round's chunks) and the mesh's shape (an adopted
    member count must tile its ensemble axis)."""
    return hashlib.sha1(repr(
        (config.algorithm, config.n_p, config.tau, config.delta,
         config.seed, config.max_rounds, slab.n_nodes,
         slab.cap_hint or slab.capacity, slab.agg_cap, slab.d_cap,
         slab.d_hyb, slab.hub_cap, config.gamma, warm, config.align_frac,
         sampler, config.closure_tau,
         tuple(mesh.shape.items()) if mesh is not None else None)
    ).encode()).hexdigest()[:10]


def rounds_block_size(dev: torch.device) -> Optional[int]:
    """The fused block size of a run on ``dev``, from FCTPU_ROUNDS_BLOCK:
    an integer is clamped to 1..BLOCK_MAX; unset is 1, one round a host
    step; ``auto`` is None on the card, where the run's first round runs
    alone and sizes the blocks by the reference's rule,
    ``min(8, 15 s / that round)`` (the reference's prior,
    est_member_seconds, is not ported), and 1 elsewhere (off the card a
    block computes both sides of every branch and every sweep of the
    budget, and saves no launches).

    Unset is not the reference's default: on the card a capture costs
    0.4-1.7 s and every budget re-derivation or growth captures again,
    so a block was slower than one round a step on every main-path run
    but karate's (PERF.md)."""
    raw = os.environ.get("FCTPU_ROUNDS_BLOCK", "").strip()
    if raw.lower() == "auto":
        return None if dev.type == "cuda" else 1
    return max(1, min(BLOCK_MAX, env_int("FCTPU_ROUNDS_BLOCK", 1)))


def batch_block_size(dev: torch.device) -> int:
    """The batched block size of ``run_consensus_batch`` on ``dev``:
    FCTPU_ROUNDS_BLOCK read as :func:`rounds_block_size` reads it, with
    ``auto`` on the card the reference's batch default, BLOCK_MAX."""
    block = rounds_block_size(dev)
    return BLOCK_MAX if block is None else block


@traced("consensus")
def run_consensus(slab: GraphSlab, detect: Detector, config: ConsensusConfig,
                  key: Optional[torch.Tensor] = None,
                  checkpoint_path: Optional[str] = None,
                  checkpoint_every: int = 1,
                  resume: bool = False,
                  on_round=None,
                  detect_cache_dir: Optional[str] = None,
                  n_closure: Optional[int] = None,
                  init_labels=None,
                  active_mask=None,
                  mesh: Optional[Mesh] = None) -> ConsensusResult:
    """Iterate rounds to delta-convergence (or ``max_rounds``), then run the
    final re-detection.  Runs on the slab's device.

    ``mesh`` (``parallel.make_mesh``): the ``n_p`` members split over its
    "p" axis (each block detected on its own device) and the slab over
    its "e" axis (``parallel.shard_slab``, again after every auto-grow
    replay), the tail running edge-locally (``ops/sharded_tail.py``).
    ``n_p`` must divide by the "p" axis; the wedge sampler is the
    scatter one ("auto" resolves to it, "csr" raises); no
    ``init_labels``.  Partitions, rounds and the slab are bit for bit the
    unsharded scatter run's; ``graph`` comes back gathered into one slab.
    A mesh that spans processes (``parallel.initialize_multihost``) runs
    SPMD: every process calls this with the same graph, config and seed,
    holds its own chunks and blocks, takes every decision from the
    collective-reduced stats, and returns the same result; process 0
    writes the checkpoint (after the gather, then a barrier).  No
    ``detect_cache_dir`` there: every process would write the same chunk
    files.

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
    set one, so the hooks cost attribute checks), under the root span
    ``consensus``, and counters on the process registry, at the
    reference's places."""
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
    if config.closure_sampler == "csr" and mesh is not None:
        raise ValueError(
            "closure_sampler='csr' is incompatible with a mesh: the CSR "
            "argsort re-gathers the edge-sharded slab every round; use "
            "'auto' or 'scatter'")
    # "auto": the sort-free engine on a mesh, the CSR fast path off it
    sampler = "scatter" if mesh is not None else (
        "csr" if config.closure_sampler == "auto" else
        config.closure_sampler)
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
        if mesh is not None:
            raise ValueError("init_labels is not supported with a mesh")
        if checkpoint_path is not None or resume:
            raise ValueError("init_labels is incompatible with "
                             "checkpoint/resume (two competing notions "
                             "of 'where the run starts')")
        init_labels = np.asarray(init_labels, np.int32)
        if init_labels.shape != (config.n_p, slab.n_nodes):
            raise ValueError(
                f"init_labels shape {init_labels.shape} != "
                f"{(config.n_p, slab.n_nodes)} (n_p, n_nodes)")
    if mesh is not None and mesh.spans_processes and detect_cache_dir:
        raise ValueError(
            "detect_cache_dir is not supported with a mesh that spans "
            "processes: every process would write the same chunk files; "
            "run without detect_cache_dir, or on a one-process mesh")
    if mesh is not None and n_p % mesh.shape[ENSEMBLE_AXIS]:
        raise ValueError(
            f"n_p={n_p} is not divisible by the mesh ensemble axis "
            f"({mesh.shape[ENSEMBLE_AXIS]}); choose an ensemble axis that "
            f"divides n_p, or round n_p up with parallel.pad_n_p")
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
    if mesh is not None:
        slab = shard_slab(slab, mesh)
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

    def mesh_rounded(m: int) -> int:
        """A driver chunk size rounded up to tile the mesh's ensemble
        axis (each chunk splits over it)."""
        if mesh is None or m >= n_p:
            return m
        p_axis = mesh.shape[ENSEMBLE_AXIS]
        return min(n_p, -(-m // p_axis) * p_axis)

    def setup_cache() -> None:
        """The detect cache's fingerprint and driver chunk size, from the
        slab's statics: at the start and after a budget re-derivation."""
        nonlocal members, cache_fp, first_setup
        os.makedirs(detect_cache_dir, exist_ok=True)
        fp_base = _cache_fingerprint(config, slab, warm, sampler, mesh)
        pinned = env_int("FCTPU_DETECT_CALL_MEMBERS")
        prev = sizing.read_sizing(detect_cache_dir) \
            if first_setup and pinned is None else None
        if pinned is not None:
            members = n_p if pinned <= 0 else mesh_rounded(min(pinned, n_p))
        elif prev is not None and prev.get("fp") == fp_base:
            # a restart adopts the killed run's chunking, whatever its
            # own sizing says, or the round's persisted chunks orphan
            members = int(prev["members"])
        else:
            members = mesh_rounded(sizing.members_per_call(
                slab, n_p, getattr(detect, "member_bytes", None)))
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
        """``det`` through the persisted driver chunks of ``tag`` (one
        chunk without the cache); on a mesh every chunk splits over
        it."""
        return lambda s, ks, init=None: _detect_chunked(
            det, s, ks, members, cache_dir=detect_cache_dir,
            cache_tag=f"{cache_fp}_{tag}", init_labels=init,
            ensemble_sharding=mesh)

    history: List[dict] = list(prior_history)
    converged = resumed_converged
    rounds = start_round
    end_round = start_round if resumed_converged else config.max_rounds
    # the round that starts from singletons runs the full-sweep detector:
    # round 0, or the first resumed round of a checkpoint without labels
    cold_start_round = start_round if cur_labels is None else -1
    job = _JobPolicy(config, detect, warm, cold_start_round, history)
    sing = torch.arange(slab.n_nodes, device=dev).expand(n_p, slab.n_nodes)
    if mesh is not None:
        sing = shard_labels(sing, mesh)
        if cur_labels is not None:
            cur_labels = shard_labels(cur_labels, mesh)
    if warm and cur_labels is None:
        cur_labels = sing
    prev_round_labels = sing
    if detect_cache_dir:
        setup_cache()

    def grow_and_replay(pre_slab, dropped: int) -> None:
        """Grow from the state the saturating round started from; the
        caller runs the round again: same key, same slot-fill order, so
        only the dropped survivors change."""
        nonlocal slab
        with tracer.span("grow_and_replay", dropped=dropped):
            obs_reg.inc("slab.regrow_events")
            new_cap = pre_slab.capacity + max(2 * dropped,
                                              pre_slab.capacity // 2)
            _logger.warning(
                "edge slab saturated (%d survivors dropped); growing "
                "capacity %d -> %d and replaying the round", dropped,
                pre_slab.capacity, new_cap)
            if mesh is not None:
                slab = shard_slab(grow_slab(gather_slab(pre_slab), new_cap),
                                  mesh)
            else:
                slab = grow_slab(pre_slab, new_cap)

    def record(stats: RoundStats, cold: bool) -> bool:
        """Append one round's host stats to the history; returns
        converged."""
        nonlocal rounds
        rounds += 1
        entry = _history_entry(stats, rounds, slab.capacity, slab.n_nodes,
                               cold)
        job.observe(entry)
        obs_counters.fold_round(entry)
        if on_round is not None:
            on_round(entry)
        return bool(stats.converged)

    def save_checkpoint() -> None:
        from fastconsensus_tpu_torch.utils import checkpoint as ckpt

        with tracer.span("checkpoint", round=rounds):
            # key data and, when warm, the labels are read back
            obs_counters.host_sync("checkpoint", 2 if warm else 1)
            # every process gathers (collectives); process 0 writes
            whole = _whole(slab)
            ck_labels = gather_labels(cur_labels, mesh) if warm else None
            if mesh is None or mesh.rank == 0:
                ckpt.save_checkpoint(
                    checkpoint_path, whole, rounds, prng.key_data(key),
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
                    labels=ck_labels,
                    telemetry=run_telemetry())
            if mesh is not None and mesh.spans_processes:
                import torch.distributed as dist

                dist.barrier()

    # Fused mode (the reference's): where a whole round is one call of
    # a blocked detector (every one: CNM's and Infomap's host C++ as a
    # host node of the graph) and nothing is persisted per round, rounds
    # run in blocks of up to BLOCK_MAX with one stats readback a block
    # (engine.RoundsBlock; a CUDA graph on the card).
    # Under warm start the blocks run warm rounds; a round that
    # re-detects from singletons (the first, a stagnation refresh) runs
    # on its own.  Block size never changes results; rounds_block_size
    # says how it is chosen.
    block_size = rounds_block_size(dev)
    runner: Optional[RoundsBlock] = None

    def fused(mode: str) -> int:
        """This step's block size (1: one round, eagerly)."""
        if block_size is None or block_size < 2 or checkpoint_path or \
                detect_cache_dir or mesh is not None or \
                not getattr(detect, "supports_block", False) or \
                (warm and mode != "warm"):
            return 1
        # a host detector runs its whole ensemble in one host call
        if not getattr(detect, "host_fn", None) and sizing.members_per_call(
                slab, n_p, getattr(detect, "member_bytes", None)) < n_p:
            return 1
        return block_size

    r = start_round
    alone = False   # the last block stopped before its first round
    try:
        while r < end_round:
            t_iter = time.perf_counter()
            regrow_budgets()
            mode = job.mode(r)
            fb = 1 if alone else fused(mode)
            alone = False
            if fb >= 2:
                if runner is None or _statics(runner.slab) != _statics(slab):
                    if runner is not None:
                        runner.close()
                    runner = RoundsBlock(
                        slab, detect_warm if warm else detect, n_p,
                        config.tau, config.delta, n_closure, warm,
                        config.align_frac if job.align_ok else 0.0,
                        sampler, config.closure_tau, active)
                noop = job.budget_noop if job.budget_noop is not None \
                    else (-1, -1, -1)
                t0 = time.perf_counter()
                with tracer.step_span("rounds_block", r, block=fb):
                    res = runner.run(
                        slab, key, cur_labels if warm else prev_round_labels,
                        r, min(fb, end_round - r), job.align(r),
                        job.pstate, config.auto_grow, noop,
                        cold_start_round)
                obs_counters.host_sync("block_stats")
                dt = time.perf_counter() - t0
                slab = res.slab
                if warm:
                    cur_labels = res.labels
                prev_round_labels = res.labels
                for st in res.stats[:res.done]:
                    converged = record(st, bool(st.cold))
                r += res.done
                if res.done:
                    # per-round samples are the block's average; the
                    # block's own wall goes to its series
                    obs_reg.observe("rounds_block.seconds", dt)
                    per_round = (time.perf_counter() - t_iter) / res.done
                    for _ in range(res.done):
                        obs_reg.observe("round.seconds", per_round)
                if res.grow:
                    grow_and_replay(slab,
                                    int(res.stats[res.done].n_dropped))
                elif res.done == 0:
                    # the block stopped before its first round, one that
                    # re-detects from singletons: it runs on its own
                    alone = True
                if converged:
                    break
                continue
            pre_slab = slab
            k = prng.stream(key, prng.STREAM_ROUND, r)
            is_cold = mode != "warm"
            round_detect = {"cold": detect, "refresh": detect_refresh,
                            "warm": detect_warm}[mode]
            if detect_cache_dir or mesh is not None:
                round_detect = chunked(round_detect, f"r{r}")
            with tracer.step_span("round", r, mode=mode):
                if warm:
                    slab_new, new_labels, stats = consensus_round(
                        slab, k, round_detect, n_p, config.tau,
                        config.delta, n_closure,
                        init_labels=sing if is_cold else cur_labels,
                        align=job.align(r) and not is_cold,
                        closure_tau=config.closure_tau,
                        prev_labels=cur_labels, sampler=sampler,
                        active=active, ensemble_sharding=mesh)
                else:
                    slab_new, new_labels, stats = consensus_round(
                        slab, k, round_detect, n_p, config.tau,
                        config.delta, n_closure,
                        closure_tau=config.closure_tau,
                        prev_labels=prev_round_labels, sampler=sampler,
                        ensemble_sharding=mesh)
                stats = stats_to_host([stats])[0]
            obs_counters.host_sync("round_stats")
            dropped = int(stats.n_dropped)
            if config.auto_grow and dropped > 0:
                grow_and_replay(pre_slab, dropped)
                continue
            slab = slab_new
            if warm:
                cur_labels = new_labels
            prev_round_labels = new_labels
            r += 1
            converged = record(stats, is_cold)
            round_s = time.perf_counter() - t_iter
            obs_reg.observe("round.seconds", round_s)
            if block_size is None:
                # the first round timed sizes the blocks (the reference's
                # prior, est_member_seconds, is not ported)
                block_size = max(1, min(BLOCK_MAX, int(15.0 / max(round_s,
                                                                  1e-9))))
            if checkpoint_path is not None and \
                    (rounds % checkpoint_every == 0 or converged):
                save_checkpoint()
            if converged:
                break
    finally:
        if runner is not None:
            runner.close()

    regrow_budgets()
    final_keys = prng.partition_keys(
        prng.stream(key, prng.STREAM_FINAL), n_p)
    # the warm variant only when the seed labels come from real detection
    final_detect = detect_warm if (
        warm and (cold_start_round == -1 or rounds > start_round)) \
        else detect
    if detect_cache_dir or mesh is not None:
        final_detect = chunked(final_detect, "final")
    with tracer.span("final_detect"):
        final_labels = final_detect(slab, final_keys,
                                    cur_labels if warm else None)
        all_labels = gather_labels(final_labels, mesh).cpu().numpy().astype(
            np.int32)
    obs_counters.host_sync("final_labels")
    partitions = [all_labels[i] for i in range(n_p)]
    if active_np is not None:
        # frozen vertices keep the parent's labels through the final
        # re-detection too
        partitions = [np.where(active_np, p, init_labels[i])
                      for i, p in enumerate(partitions)]
    return ConsensusResult(partitions=partitions, graph=_whole(slab),
                           rounds=rounds, converged=converged,
                           history=history)


def _whole(slab) -> GraphSlab:
    """A slab in one piece: a sharded one gathered, a whole one as is."""
    return gather_slab(slab) if isinstance(slab, ShardedSlab) else slab


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
    reads back one stack of stats.

    **Batched blocks** (``engine.BatchBlock``, the reference's
    ``consensus_batch_block``): with FCTPU_ROUNDS_BLOCK at 2 or more
    (clamped to 8), or ``auto`` on the card (8, the reference's batch
    default), the warm rounds (every round without warm start) of a
    detector with ``supports_block`` run up to that many at a time, with
    one readback of every job's stats, each folded into its job's policy
    as one round a step folds it; on the card the batched round is
    captured once a run into a CUDA graph.  A round 0 and a masked
    refresh still run as one batched round; a job freezes inside a block
    where one round a step would drop it or split it off, and a refresh
    due for any job ends the block for all.  The stacked stream must be
    one member chunk, the solo driver's rule.  **Departure**: unset (or
    1) keeps one batched round a host step, where the reference blocks
    at 8 by default; off the card ``auto`` is one round a step too (a
    block there computes both sides of every branch).  The host
    detectors (CNM, Infomap) block too: one host step a batched round
    detects every job that runs, in job order (``engine.HostDetect``;
    a host node of the captured graph on the card).

    **Bit-parity contract**: every job's
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
    split job to the reason.  fcobs: under the root span
    ``consensus_batch`` (arg ``b``), a ``batch_round`` span a batched round
    (args ``mode``, ``active``: the jobs it runs, ``rounds``: their least
    and greatest round) or ``batch_block`` a block, then
    ``batch_final_detect``; counters ``batch.rounds`` and
    ``batch.job_rounds`` (the jobs' rounds run in them).
    """
    with get_tracer().span("consensus_batch", b=len(slabs)):
        return _run_consensus_batch(slabs, detect, config, n_closure, seeds,
                                    keys)


def _run_consensus_batch(slabs: List[GraphSlab], detect: Detector,
                         config: ConsensusConfig, n_closure: int, seeds,
                         keys) -> BatchResults:
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

    # Batched blocks (engine.BatchBlock; one captured CUDA graph on the
    # card for the whole run): FCTPU_ROUNDS_BLOCK as the solo driver reads
    # it, "auto" the reference's batch default of BLOCK_MAX on the card.
    # Warm rounds (or every round without warm start) of a detector whose
    # round is one call, with its stacked detection in one member chunk
    # (the solo fused() rule); round 0 and refreshes run alone
    block = batch_block_size(dev)
    det_block = detect_warm if warm else detect
    if block >= 2 and not (
            getattr(detect, "supports_block", False) and
            (getattr(detect, "host_fn", None) or (
                getattr(detect, "supports_stack", False) and
                det_block.chunk_of(stack_slabs(cur), B * n_p) >= B * n_p))):
        block = 1
    runner: Optional[BatchBlock] = None

    def record(i: int, st: RoundStats, capacity: int, cold: bool) -> None:
        """Fold one of job i's rounds into its policy and history."""
        rounds[i] += 1
        jobs[i].observe(_history_entry(st, int(rounds[i]), capacity,
                                       n_nodes, cold))
        conv[i] = bool(st.converged)

    def run_block() -> None:
        """Up to ``block`` rounds of every active job in one batched
        block, with one readback."""
        nonlocal runner
        mask = active()
        idx = [int(i) for i in np.flatnonzero(mask)]
        if not idx:
            return
        if runner is None:
            runner = BatchBlock(cur[0], B, det_block, n_p, config.tau,
                                config.delta, n_closure, warm,
                                config.align_frac if jobs[0].align_ok
                                else 0.0, sampler, config.closure_tau)
        iters = np.where(mask, np.minimum(block, config.max_rounds - rounds),
                         0)
        mode = "warm" if warm else "scratch"
        with tracer.step_span("batch_block", int(rounds[idx].min()), b=B,
                              mode=mode, block=int(iters.max())):
            res = runner.run(
                cur, keys, labels, rounds, iters,
                [bool(mask[i]) and jobs[i].align(int(rounds[i]))
                 for i in range(B)],
                [jobs[i].pstate for i in range(B)], config.auto_grow,
                [jobs[i].budget_noop if jobs[i].budget_noop is not None
                 else (-1, -1, -1) for i in range(B)])
        obs_counters.host_sync("batch_block_stats")
        obs_reg.inc("batch.blocks")
        obs_reg.inc("batch.rounds", max(res.done[i] for i in idx))
        obs_reg.inc("batch.job_rounds", sum(res.done[i] for i in idx))
        for i in idx:
            done = res.done[i]
            for st in res.stats[i][:done]:
                record(i, st, res.slabs[i].capacity, bool(st.cold))
            if done:
                cur[i], labels[i] = res.slabs[i], res.labels[i]
            if res.grow[i]:
                # run_consensus would grow the slab and replay
                split_off(i, f"slab saturated at round {rounds[i]}")
            elif done and jobs[i].regrow_budgets(cur[i]) is not cur[i]:
                split_off(i, f"budget re-derivation after round "
                             f"{rounds[i]}")

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
        with tracer.step_span("batch_round", int(rounds[idx].min()), b=B,
                              mode=mode, active=len(idx),
                              rounds=[int(rounds[idx].min()),
                                      int(rounds[idx].max())]):
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
        obs_reg.inc("batch.rounds")
        obs_reg.inc("batch.job_rounds", len(idx))
        for i, (slab_new, lab, _), st in zip(idx, out, host):
            if config.auto_grow and int(st.n_dropped) > 0:
                # run_consensus would grow the slab and replay
                split_off(i, f"slab saturated at round {rounds[i]}")
                continue
            record(i, st, slab_new.capacity, mode != "warm")
            cur[i], labels[i] = slab_new, lab
            # run_consensus re-derives starved budgets before its next
            # round and its final re-detection: new statics leave the
            # bucket
            if jobs[i].regrow_budgets(slab_new) is not slab_new:
                split_off(i, f"budget re-derivation after round "
                             f"{rounds[i]}")

    try:
        if warm:
            # absolute round 0: uniformly cold (singleton-init full sweeps)
            run_round("cold", detect)
            while active().any():
                # fcheck: ok=sync-in-loop (host bookkeeping: active() is a
                # numpy mask and mode() reads host state; no tensor here)
                refresh = np.array([bool(a) and
                                    jobs[i].mode(int(rounds[i])) == "refresh"
                                    for i, a in enumerate(active())])
                if refresh.any():
                    obs_reg.inc("batch.refresh_rounds", int(refresh.sum()))
                    run_round("cold", detect_refresh, only=refresh)
                    continue
                if block >= 2:
                    run_block()
                else:
                    run_round("warm", detect_warm)
        else:
            while active().any():
                if block >= 2:
                    run_block()
                else:
                    run_round("scratch", detect)
    finally:
        if runner is not None:
            runner.close()

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
