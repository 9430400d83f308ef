"""The serving surface's device-memory model: the port's counterpart of
the reference's serving-executable tracer
(``fastconsensus_tpu/analysis/entrypoints.py``, ``trace_serving_executable``).

The reference traces each executable a served bucket compiles to a
jaxpr and sweeps its liveness (``footprint.peak_live_bytes``).  The port
runs eagerly and has no jaxpr, so its counterpart is a byte model of the
port's own tensors at each part of a served job, summed from the models
the card checks: the detectors' per-member sweep models
(``louvain.sweep_temp_bytes``, ``leiden.member_bytes``,
``lpm.member_bytes``), the member chunk ``sizing.members_per_call``
gives them, and the tail's ``engine.tail_temp_bytes``.  It imports
torch only for the shapes of a slab: the model's slabs live on the
``meta`` device and hold no memory.

The kinds are the reference's :data:`SERVING_KINDS`, each priced as the
port runs it (``E`` slots of ``SLAB_SLOT_BYTES``, ``N`` nodes, ``P =
n_p`` members, ``K = b * P`` members of a batch, int64 labels):

* ``detect`` — one detection call (``models/base.ensemble``): the slab,
  the keys and the ``[P, N]`` init labels; the prepared state (strengths
  and the sweep's rows: the matmul ``[N, N]`` weights, the dense or
  hybrid rows with the hub prefix) or, before the sweeps, its build; a
  chunk of ``members_per_call`` members, each its per-member model; and
  the members' labels, as the chunks collect and are joined.
* ``tail`` — ``engine.consensus_tail``: the slab, the labels and the
  previous labels, plus ``tail_temp_bytes`` (the new slab included).
* ``rounds`` — one solo round (``engine.consensus_round``, the unit
  ``run_consensus`` repeats): the slab and the round-entering labels,
  plus the larger of the detection and the new labels beside the tail.
* ``batch`` — one round of ``b`` jobs (``engine.consensus_batch_round``):
  the jobs' slabs and labels; while they detect, their stacked slab, the
  joined init labels (warm and cold rounds) and one detection stream of
  ``K`` members, each member also holding its copy of its graph's state
  (``member_copy_bytes``); then the ``[K, N]`` labels, the new slabs and
  one tail at a time.
* ``detect-batch`` — the batch's final detection (``detect_stacked``):
  the jobs' slabs beside their stack, the joined init labels and the
  stream of ``K`` members.

Two levels: :func:`slab_peak_bytes` is the model at one concrete slab
geometry (a served job's own packed slab), and :func:`serving_peak_bytes`
the bucket's worst case, the largest over the sweep paths and row
budgets a graph of the bucket can derive (``graph.derive_dense_sizing``,
``derive_hybrid_sizing``, ``select_move_path``).  The chunk term,
``chunk x unit``, is not monotone in the per-member ``unit`` (a larger
member fits fewer to a chunk), so the worst case prices it by its bound
``min(K x unit, max(budget, unit))``, which no geometry exceeds.  A
member whose unit alone passes ``FCTPU_ENSEMBLE_BUDGET_MB`` runs in
chunks of one, and the result says so (``over_budget``).  Growth of a
slab past its bucket's capacity (``auto_grow``) is not priced, as the
reference's model does not price it.

``trace_serving_executable`` has no counterpart: there is no program to
trace.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

SERVING_KINDS = ("rounds", "batch", "tail", "detect", "detect-batch")
# The modes each kind takes (the reference's static variants): the solo
# rounds warm or from scratch, the batch warm, cold or from scratch.
KIND_MODES = {"rounds": ("warm", "scratch"),
              "batch": ("warm", "cold", "scratch"),
              "tail": ("-",), "detect": ("-",), "detect-batch": ("-",)}
ALGORITHMS = ("louvain", "leiden", "lpm")
# Bytes of a label and of a PRNG key.
LABEL_BYTES = 8
KEY_BYTES = 16
# Transient bytes a slot of the directed slab costs while the prepared
# rows are built (the directed copy, the sort key, order and sorted key,
# row positions and the gathered values; engine's sort scratch aside).
_BUILD_SLOT_BYTES = 2 * (21 + 5 * 8)


def meta_slab(n_nodes: int, capacity: int, d_cap: int = 0, d_hyb: int = 0,
              hub_cap: int = 0, agg_cap: int = 0, cap_hint: int = 0):
    """A slab of this geometry on the ``meta`` device: the shapes and
    statics of a packed slab, no memory."""
    import torch

    from fastconsensus_tpu_torch.graph import GraphSlab

    def empty(dtype):
        return torch.empty(capacity, dtype=dtype, device="meta")

    return GraphSlab(src=empty(torch.int64), dst=empty(torch.int64),
                     weight=empty(torch.float32), alive=empty(torch.bool),
                     n_nodes=int(n_nodes), d_cap=int(d_cap),
                     cap_hint=int(cap_hint), d_hyb=int(d_hyb),
                     hub_cap=int(hub_cap), agg_cap=int(agg_cap))


def _member_model(algorithm: str) -> Callable:
    if algorithm == "lpm":
        from fastconsensus_tpu_torch.models import lpm

        return lpm.member_bytes
    if algorithm == "leiden":
        from fastconsensus_tpu_torch.models import leiden

        return leiden.member_bytes
    if algorithm == "louvain":
        from fastconsensus_tpu_torch.models import louvain

        return louvain.sweep_temp_bytes
    raise ValueError(f"no memory model for algorithm {algorithm!r}; one "
                     f"of {ALGORITHMS}")


def path_of(slab, algorithm: str = "louvain") -> str:
    """The sweep the detector takes on ``slab``: Louvain's and Leiden's
    ``select_move_path``; LPM's dense vote or runs vote."""
    if algorithm == "lpm":
        return "dense vote" if slab.d_cap > 0 else "runs vote"
    from fastconsensus_tpu_torch.models.louvain import select_move_path

    return select_move_path(slab)


def _rows_bytes(slab, algorithm: str) -> int:
    """A graph's prepared rows (``louvain.Prepared``/``lpm.Prepared``):
    the matmul weights, or the dense rows (id, weight, valid: 13 bytes a
    slot), or the hybrid rows with the hub flags and prefix."""
    n = slab.n_nodes
    path = path_of(slab, algorithm)
    if path == "matmul":
        return 4 * n * n
    if path in ("dense", "dense vote"):
        return 13 * n * slab.d_cap
    if path == "hybrid":
        return 13 * n * slab.d_hyb + n + 21 * slab.hub_cap
    return 0


def state_bytes(slab, algorithm: str = "louvain") -> int:
    """One graph's prepared state: its rows, plus Louvain's and Leiden's
    strengths and 2m."""
    extra = 0 if algorithm == "lpm" else 4 * slab.n_nodes + 4
    return _rows_bytes(slab, algorithm) + extra


def copy_bytes(slab, algorithm: str = "louvain") -> int:
    """What a graph-stacked detection copies for each member
    (``Prepared.member_copy_bytes``): the slab's slots and the graph's
    state, the matmul weights apart (read through ``w_rows``)."""
    from fastconsensus_tpu_torch.engine import SLAB_SLOT_BYTES

    rows = 0 if path_of(slab, algorithm) == "matmul" else \
        _rows_bytes(slab, algorithm)
    extra = 0 if algorithm == "lpm" else 4 * slab.n_nodes + 4
    return SLAB_SLOT_BYTES * slab.capacity + rows + extra


def _budget() -> Tuple[int, int]:
    """(FCTPU_ENSEMBLE_CHUNK or 0, the member budget in bytes), as
    ``sizing.members_per_call`` reads them."""
    from fastconsensus_tpu_torch.utils.env import env_int

    return (env_int("FCTPU_ENSEMBLE_CHUNK") or 0,
            env_int("FCTPU_ENSEMBLE_BUDGET_MB", 2048) << 20)


def detect_terms(slab, k: int, algorithm: str = "louvain",
                 graphs: int = 0, bound: bool = False) -> Dict[str, int]:
    """The detection of ``k`` members on ``slab`` (``graphs`` > 0: a
    stack of that many graphs), term by term: ``member`` (one member's
    model), ``copy`` (its copy of its graph's state), ``chunk``
    (``sizing.members_per_call``), ``work`` (``chunk x unit``, or with
    ``bound`` its bound ``min(k x unit, max(budget, unit))``),
    ``state`` and ``build`` (the graphs' prepared state and its build),
    ``labels`` (the members' int64 labels) and ``peak``: the state plus
    the larger of its build, the work beside the labels collected so
    far, and the labels with their join."""
    from fastconsensus_tpu_torch.sizing import members_per_call

    member_fn = _member_model(algorithm)
    member = member_fn(slab)
    copy = copy_bytes(slab, algorithm) if graphs else 0
    unit = member + copy
    chunk = members_per_call(slab, k, member_fn, copy)
    fixed, budget = _budget()
    if bound and not fixed:
        work = min(k * unit, max(budget, unit))
    else:
        work = chunk * unit
    g = max(graphs, 1)
    state = g * state_bytes(slab, algorithm)
    build = 0 if path_of(slab, algorithm) in ("hash", "runs", "runs vote") \
        else g * _BUILD_SLOT_BYTES * slab.capacity
    labels = LABEL_BYTES * k * slab.n_nodes
    return {"member": member, "copy": copy, "chunk": chunk,
            "over_budget": int(not fixed and unit > budget),
            "work": work, "state": state, "build": build, "labels": labels,
            "peak": state + max(build, work + labels, 2 * labels)}


def peak_terms(kind: str, slab, b: int = 1, mode: str = "warm",
               n_p: int = 20, algorithm: str = "louvain",
               n_closure: int = 0, bound: bool = False) -> Dict[str, int]:
    """The model of ``kind`` at ``slab``'s geometry, term by term (see the
    module docstring): ``args`` (what the call is given), ``detect``
    (:func:`detect_terms`), ``tail`` (``engine.tail_temp_bytes``),
    ``out`` (what it returns) and ``peak``.  ``n_closure`` defaults to
    the bucket's wedge count, ``(capacity - 16) // 2``."""
    from fastconsensus_tpu_torch.engine import (SLAB_SLOT_BYTES,
                                                tail_temp_bytes)

    if kind not in SERVING_KINDS:
        raise ValueError(f"unknown serving kind {kind!r}; one of "
                         f"{SERVING_KINDS}")
    if KIND_MODES[kind] != ("-",) and mode not in KIND_MODES[kind]:
        raise ValueError(f"kind {kind!r} has no mode {mode!r}; one of "
                         f"{KIND_MODES[kind]}")
    b = max(int(b), 1) if kind in ("batch", "detect-batch") else 1
    n_p = int(n_p)
    k = b * n_p
    n_closure = int(n_closure) or max((slab.capacity - 16) // 2, 1)
    sl = SLAB_SLOT_BYTES * slab.capacity
    lab = LABEL_BYTES * n_p * slab.n_nodes
    t = {"slab": sl, "labels": lab, "tail": 0, "detect": 0}
    if kind == "detect":
        d = detect_terms(slab, n_p, algorithm, bound=bound)
        args = sl + KEY_BYTES * n_p + lab
        peak = args + d["peak"]
        out = lab
    elif kind == "tail":
        d = None
        t["tail"] = tail_temp_bytes(slab, n_p, n_closure)
        args = sl + 2 * lab + KEY_BYTES
        peak = args + t["tail"]
        out = sl
    elif kind == "rounds":
        d = detect_terms(slab, n_p, algorithm, bound=bound)
        t["tail"] = tail_temp_bytes(slab, n_p, n_closure)
        args = sl + lab + KEY_BYTES
        peak = args + max(KEY_BYTES * n_p + d["peak"], lab + t["tail"])
        out = sl + lab
    elif kind == "batch":
        d = detect_terms(slab, k, algorithm, graphs=b, bound=bound)
        t["tail"] = tail_temp_bytes(slab, n_p, n_closure)
        args = b * (sl + lab + KEY_BYTES)
        init = b * lab if mode in ("warm", "cold") else 0
        peak = args + max(b * sl + init + KEY_BYTES * k + d["peak"],
                          b * lab + (b - 1) * sl + t["tail"])
        out = b * (sl + lab)
    else:                                    # detect-batch
        d = detect_terms(slab, k, algorithm, graphs=b, bound=bound)
        args = 2 * b * sl + KEY_BYTES * k + b * lab
        peak = args + d["peak"]
        out = b * lab
    if d is not None:
        t["detect"] = d["peak"]
        t.update({f"detect_{key}": v for key, v in d.items()
                  if key != "peak"})
    t.update(args=args, peak=peak, out=out)
    return t


def slab_peak_bytes(kind: str, slab, b: int = 1, mode: str = "warm",
                    n_p: int = 20, algorithm: str = "louvain",
                    n_closure: int = 0) -> Dict:
    """Model (a): ``{"peak", "arg_bytes", "out_bytes", "path", "chunk",
    "over_budget"}`` of ``kind`` at one concrete slab geometry (a packed
    slab on any device, or :func:`meta_slab`)."""
    t = peak_terms(kind, slab, b=b, mode=mode, n_p=n_p, algorithm=algorithm,
                   n_closure=n_closure)
    return {"peak": t["peak"], "arg_bytes": t["args"],
            "out_bytes": t["out"], "path": path_of(slab, algorithm),
            "chunk": t.get("detect_chunk"),
            "over_budget": bool(t.get("detect_over_budget", 0))}


def bucket_geometries(n_class: int, e_class: int,
                      algorithm: str = "louvain") -> List:
    """The slab geometries a graph of bucket ``(n_class, e_class)`` can
    reach in a served run, as meta slabs: the bucket's padded slab (no
    rows: the matmul sweep up to ``MATMUL_MAX_N`` nodes, else the hash
    sweep or LPM's runs vote) and, past ``MATMUL_MAX_N``, what a budget
    re-derivation from the live degrees (at most ``capacity`` alive
    slots) can give it on each sweep that would take it: the widest
    width ``derive_dense_sizing`` returns for some degree, and every cut
    ``derive_hybrid_sizing`` can choose, each with the largest hub mass
    its cost rule admits there (``3 N (d+1) + 6 hub_mass < 16 alive``)
    and the hub prefix ``hub_cap_for`` sizes for it."""
    import os

    return list(_geometries(int(n_class), int(e_class), algorithm,
                            os.environ.get("FCTPU_MOVE_PATH", "")))


@functools.lru_cache(maxsize=1024)
def _geometries(n_class: int, e_class: int, algorithm: str,
                move_path: str) -> Tuple:
    import numpy as np

    from fastconsensus_tpu_torch.analysis.footprint import (
        MATMUL_MAX_N, bucket_agg_cap, bucket_capacity)
    from fastconsensus_tpu_torch.graph import (DENSE_D_MAX,
                                               derive_dense_sizing,
                                               hub_cap_for)

    n, cap = int(n_class), bucket_capacity(e_class)
    base = dict(n_nodes=n, capacity=cap, cap_hint=cap,
                agg_cap=bucket_agg_cap(e_class))
    out = [meta_slab(**base)]
    if n <= MATMUL_MAX_N and algorithm != "lpm":
        return out
    # degrees past ~0.8 DENSE_D_MAX derive no dense width (it passes
    # DENSE_D_MAX); alive slots, so degrees, are bounded by the capacity
    max_deg = min(n - 1, cap)
    widths = {derive_dense_sizing(np.array([d]), n)
              for d in range(0, min(max_deg, DENSE_D_MAX) + 1)} - {0}
    dense = [w for w in sorted(widths)
             if path_of(meta_slab(d_cap=w, **base), algorithm)
             in ("dense", "dense vote")]
    if dense:
        out.append(meta_slab(d_cap=dense[-1], **base))
    if algorithm != "lpm":
        hi = min(max(((max_deg + 7) // 8) * 8, 8), DENSE_D_MAX,
                 max(n - 1, 1))
        for d in range(8, hi + 1, 8):
            hub_mass = min(2 * cap, (16 * cap - 3 * n * (d + 1) - 1) // 6)
            if hub_mass < 0:
                break
            geom = meta_slab(d_hyb=d, hub_cap=hub_cap_for(hub_mass), **base)
            if path_of(geom, algorithm) == "hybrid":
                out.append(geom)
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def _bucket_peak(kind, n_class, e_class, b, mode, n_p, algorithm, env):
    import logging

    logger = logging.getLogger("fastconsensus_tpu_torch")
    level = logger.level
    # the hash tables' size cap warns at the ladder's top buckets: a
    # run's warning, not the model's
    logger.setLevel(logging.ERROR)
    try:
        best = None
        for slab in bucket_geometries(n_class, e_class, algorithm):
            t = peak_terms(kind, slab, b=b, mode=mode, n_p=n_p,
                           algorithm=algorithm, n_closure=e_class,
                           bound=True)
            if best is None or t["peak"] > best[0]["peak"]:
                best = (t, slab)
    finally:
        logger.setLevel(level)
    t, slab = best
    return {"peak": t["peak"], "arg_bytes": t["args"],
            "out_bytes": t["out"], "path": path_of(slab, algorithm),
            "chunk": t.get("detect_chunk"),
            "over_budget": bool(t.get("detect_over_budget", 0))}


def serving_peak_bytes(kind: str, n_class: int, e_class: int, b: int = 1,
                       mode: str = "warm", n_p: int = 20,
                       algorithm: str = "louvain") -> Dict:
    """Model (b), the bucket's worst case: ``{"peak", "arg_bytes",
    "out_bytes", "path", "chunk", "over_budget"}`` of ``kind`` at bucket
    ``(n_class, e_class)``, the largest over :func:`bucket_geometries`
    with the chunk term at its bound (module docstring), the wedge count
    the bucket's ``e_class``.  ``mode`` "-" stands for a kind's first
    mode; the kinds without modes ignore it."""
    import os

    if kind not in SERVING_KINDS:
        raise ValueError(f"unknown serving kind {kind!r}; one of "
                         f"{SERVING_KINDS}")
    if mode == "-":
        mode = KIND_MODES[kind][0]
    env = tuple(os.environ.get(v, "") for v in (
        "FCTPU_ENSEMBLE_CHUNK", "FCTPU_ENSEMBLE_BUDGET_MB",
        "FCTPU_MOVE_PATH"))
    return dict(_bucket_peak(kind, int(n_class), int(e_class), int(b),
                             mode, int(n_p), algorithm, env))
