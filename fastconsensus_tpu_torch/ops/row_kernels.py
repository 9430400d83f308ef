"""Hopper kernels for the per-sweep row aggregation, with their plain
PyTorch versions, launch counters and the nvcc build.

Two kernels replace the two Pallas TPU kernels of
``fastconsensus_tpu/ops/pallas_kernels.py``:

* ``row_totals`` (``csrc/row_totals.cu``) — per padded row, each slot's
  label total and first-occurrence head.  Every dense and hybrid Louvain
  sweep runs it (ops/dense_adj.row_label_totals).
* ``fused_move_rows`` (``csrc/fused_move_rows.cu``) — a whole dense move
  sweep per row (opt-in, ``FCTPU_FUSED=1`` on the dense path).

Both take their totals from one aggregation, ``csrc/row_agg.cuh``, in two
regimes: rows of up to ``FLAT_MAX_D`` slots go through flat tiles of whole
rows (a persistent, double-buffered grid; a thread folds a 9- or 17-slot
chunk of a row), wider rows (up to 2048 slots) are sorted in shared
memory by 32-bit (label, slot) keys.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises — there is no fallback.  Each wrapper adds
one to ``LAUNCHES[name]`` where it launches its kernel and nowhere else;
``row_totals`` also counts its launches by shape, ``(rows, D)``, in
``ROW_TOTALS_SHAPES``.

Under CUDA-graph capture (the fused round block, ``ops/capture.py``) a
wrapper's call launches nothing: its launches happen at each replay.  The
wrapper then records, beside the launch, a one-element add into its
``(name, shape)`` slot of a device counter (:func:`device_counts`), and
the block's one readback folds the slots into ``LAUNCHES`` and
``ROW_TOTALS_SHAPES`` (:func:`fold_device_counts`), so the counts stay
those of the launches made.

Build: each source compiles with its own ``nvcc`` process (all started
together) into ``fastconsensus_tpu_torch/_build/`` at first use, keyed by
the content hash of the source, every header under ``csrc/`` and the
flags, and loads with ctypes: a plain C entry point
that launches on the current stream of the tensors' device and returns
``cudaGetLastError()``.  ``csrc/graph_cond.cu`` (the capture's
conditional nodes) and ``csrc/host_node.cu`` (its host nodes) build
beside the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

from fastconsensus_tpu_torch.analysis.recompile_guard import note_build

SENTINEL = 2 ** 31 - 1

# Widest row of the flat-tile regime: ROW_AGG_FLAT_MAX in csrc/row_agg.cuh.
FLAT_MAX_D = 64

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = {"row_totals": "row_totals.cu",
           "fused_move_rows": "fused_move_rows.cu"}
# Built and loaded like the kernels; no launch counts (ops/capture.py).
CONTROL_SOURCES = {"graph_cond": "graph_cond.cu",
                   "host_node": "host_node.cu"}
_ALL_SOURCES = {**SOURCES, **CONTROL_SOURCES}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
ROW_TOTALS_SHAPES: Counter = Counter()

# Launches recorded into a CUDA graph: a slot of a per-device int64
# counter for each (kernel, shape), assigned at capture.
MAX_DEVICE_SLOTS = 256
_DEVICE_SLOTS: Dict[Tuple[str, Tuple[int, int]], int] = {}
_device_counts: Dict[torch.device, torch.Tensor] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# Rows per chunk of the plain versions' [rows, D, D] compare, bounding its
# temporaries to ~64M elements.
_PLAIN_ELEMS = 1 << 26


class KernelBuildError(RuntimeError):
    """A CUDA kernel's source did not build (no ``nvcc``, or ``nvcc``
    failed)."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROW_TOTALS_SHAPES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in ("/usr/local/cuda/bin/nvcc",):
        if os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be "
                           "built (needs the CUDA toolkit)")


def _lib_path(name: str) -> Path:
    """Build path keyed by the source, every ``*.cuh`` under ``csrc/`` (a
    source may include any of them) and the flags."""
    h = hashlib.sha1((CSRC / _ALL_SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the sources (default: the kernels' and ``graph_cond``'s)
    that are not built yet, one ``nvcc`` per source, all running at once.
    Returns ``{name: {"seconds": s, "cached": bool, "ptxas": text}}``;
    raises if any build fails.  Each source it compiles counts one build
    (``analysis.CompileGuard``)."""
    names = list(_ALL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / _ALL_SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, lib)
        note_build(f"nvcc:{name}")
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "ptxas": text}
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return out


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{name}: CUDA is not available; the kernel cannot launch "
                f"(pass CPU tensors to use the plain version)")
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        if name == "graph_cond":
            lib.graph_cond_if_begin.argtypes = [ctypes.c_void_p] * 3
            lib.graph_cond_if_begin.restype = ctypes.c_int
            lib.graph_cond_if_end.argtypes = [ctypes.c_void_p]
            lib.graph_cond_if_end.restype = ctypes.c_int
            lib.graph_cond_status.argtypes = [ctypes.c_void_p]
            lib.graph_cond_status.restype = ctypes.c_int
            lib.graph_cond_stream_create.argtypes = []
            lib.graph_cond_stream_create.restype = ctypes.c_void_p
            _libs[name] = lib
            return lib
        if name == "host_node":
            lib.host_node_launch.argtypes = [ctypes.c_void_p] * 3
            lib.host_node_launch.restype = ctypes.c_int
            lib.host_node_alloc.argtypes = [ctypes.c_size_t]
            lib.host_node_alloc.restype = ctypes.c_void_p
            lib.host_node_free.argtypes = [ctypes.c_void_p]
            lib.host_node_free.restype = ctypes.c_int
            _libs[name] = lib
            return lib
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        if name == "row_totals":
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
        _libs[name] = lib
        return lib


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _check_cuda(name: str, specs) -> None:
    for arg, t, dtype, ndim in specs:
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: {arg} is on {t.device}, expected a "
                               f"CUDA tensor")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dtype} "
                             f"tensor of rank {ndim}, got {t.dtype} "
                             f"{tuple(t.shape)} contiguous="
                             f"{t.is_contiguous()}")


def _indexed(device: torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_counts(device: torch.device) -> torch.Tensor:
    """The device's launch counter, int64[MAX_DEVICE_SLOTS] (made on first
    use, which must come before a capture: ``ops/capture.py`` asks)."""
    device = _indexed(device)
    counts = _device_counts.get(device)
    if counts is None:
        counts = torch.zeros(MAX_DEVICE_SLOTS, dtype=torch.int64,
                             device=device)
        _device_counts[device] = counts
    return counts


def fold_device_counts(device: torch.device, values) -> None:
    """Add the replayed launches ``values`` (the device counter read back,
    one int per slot) to ``LAUNCHES`` and ``ROW_TOTALS_SHAPES``, and zero
    the device counter."""
    for (name, shape), slot in list(_DEVICE_SLOTS.items()):
        v = int(values[slot])
        if v:
            LAUNCHES[name] += v
            if name == "row_totals":
                ROW_TOTALS_SHAPES[shape] += v
    _device_counts[_indexed(device)].zero_()


def _count_launch(name: str, shape: Tuple[int, int],
                  device: torch.device) -> None:
    """One launch of ``name`` at ``shape``: on the host counts, or, under
    graph capture, as a captured add into its device slot."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1
        if name == "row_totals":
            ROW_TOTALS_SHAPES[shape] += 1
        return
    counts = _device_counts.get(device)
    if counts is None:
        raise RuntimeError(f"{name}: a launch under graph capture needs the "
                           f"device's launch counter (ops.capture makes it)")
    with _lock:
        slot = _DEVICE_SLOTS.setdefault((name, shape), len(_DEVICE_SLOTS))
    if slot >= MAX_DEVICE_SLOTS:
        raise RuntimeError(f"more than {MAX_DEVICE_SLOTS} (kernel, shape) "
                           f"launch slots under graph capture")
    counts[slot].add_(1)


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


# ---------------------------------------------------------------------------
# row_totals
# ---------------------------------------------------------------------------

def row_totals_plain(lab: torch.Tensor, w: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [R, D, D] broadcast compare, in row chunks.  The sum order is
    torch's; with integer weights (the main path's) it is exact."""
    r, d = lab.shape
    total = torch.empty((r, d), dtype=torch.float32, device=lab.device)
    head = torch.empty((r, d), dtype=torch.bool, device=lab.device)
    earlier = torch.ones((d, d), dtype=torch.bool,
                         device=lab.device).tril(-1)       # [i, j]: j < i
    step = max(1, _PLAIN_ELEMS // max(d * d, 1))
    for s in range(0, r, step):
        lb = lab[s:s + step]
        eq = lb[:, :, None] == lb[:, None, :]              # [b, i, j]
        total[s:s + step] = torch.where(
            eq, w[s:s + step, None, :], 0.0).sum(dim=2)
        head[s:s + step] = ~(eq & earlier).any(dim=2) & (lb != SENTINEL)
    return total, head


def row_totals_fold(lab: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Totals in the kernel's own sum order, the left fold over matching
    slots in ascending j (each step ``t + 0`` or ``t + w[j]``, exact in
    float32).  The checks hold the kernel to it bit for bit at any weights;
    ``row_totals_plain`` sums in torch's order, equal only for integers."""
    total = torch.zeros(lab.shape, dtype=torch.float32, device=lab.device)
    for j in range(lab.shape[1]):
        total += torch.where(lab == lab[:, j:j + 1], w[:, j:j + 1], 0.0)
    return total


def row_totals_cuda(lab: torch.Tensor, w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/row_totals.cu`` on ``lab`` int32[R, D], ``w``
    float32[R, D] (contiguous, on the card)."""
    _check_cuda("row_totals", [("lab", lab, torch.int32, 2),
                               ("w", w, torch.float32, 2)])
    if w.shape != lab.shape:
        raise ValueError(f"row_totals: w {tuple(w.shape)} != lab "
                         f"{tuple(lab.shape)}")
    fn = _load("row_totals").row_totals_launch
    r, d = lab.shape
    total = torch.empty((r, d), dtype=torch.float32, device=lab.device)
    head = torch.empty((r, d), dtype=torch.bool, device=lab.device)
    # the launch goes to the current device's context: make it the
    # tensors' (a mesh shard's device need not be the current one)
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        _count_launch("row_totals", (r, d), lab.device)
        _raise_on("row_totals", fn(lab.data_ptr(), w.data_ptr(),
                                   total.data_ptr(), head.data_ptr(), r, d,
                                   stream))
    return total, head


def row_totals(lab: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(total float32[R, D], head bool[R, D])`` for padded rows
    (SENTINEL = empty slot, weight 0 there); slot order preserved."""
    if _on_cpu(lab):
        return row_totals_plain(lab, w)
    return row_totals_cuda(lab, w)


# ---------------------------------------------------------------------------
# fused_move_rows
# ---------------------------------------------------------------------------

def hash_jitter(row_id: torch.Tensor, d: int, salt: torch.Tensor
                ) -> torch.Tensor:
    """Per-(row, slot) uniform in [0, 1) from a uint32 multiply-xorshift of
    (row id, slot, salt): ``float32[R, d]``."""
    from fastconsensus_tpu_torch.utils.prng import M32, mul32

    i = (row_id.to(torch.int32).to(torch.int64) & M32)[:, None]
    j = torch.arange(d, dtype=torch.int64, device=row_id.device)[None, :]
    m = (mul32(i, 0x9E3779B1) + mul32(j, 0x85EBCA77) + salt[:, None]) & M32
    m = m ^ (m >> 15)
    m = mul32(m, 0x2C1B3C6D)
    m = m ^ (m >> 13)
    return (m >> 9).to(torch.float32) * 2.0 ** -23


def fused_move_rows_plain(lab: torch.Tensor, w: torch.Tensor,
                          sig: torch.Tensor, scal: torch.Tensor,
                          d_self: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused sweep (same arithmetic as the kernel)."""
    from fastconsensus_tpu_torch.utils.prng import M32

    r, d = lab.shape
    total, head = row_totals_plain(lab, w)
    real = lab != SENTINEL
    k_i, coef, jscale = scal[:, 0:1], scal[:, 1:2], scal[:, 2:3]
    margin = scal[:, 3]
    salt = scal[:, 4].to(torch.int32).to(torch.int64) & M32
    own_lab = lab[:, d_self]
    own = lab == own_lab[:, None]
    gain = total - coef * (sig - torch.where(own, k_i, 0.0))
    jit = hash_jitter(scal[:, 5], d, salt) * jscale
    ok = head & real
    score = torch.where(ok, gain + jit, float("-inf"))
    best_score = score.max(dim=1).values
    is_best = score == best_score[:, None]
    best_lab = torch.where(is_best & ok, lab, -1).max(dim=1).values
    stay = torch.where(own & ok, gain, float("-inf")).max(dim=1).values
    has = best_score > float("-inf")
    want = has & (best_lab != own_lab) & (best_score > stay + margin)
    return torch.where(has, best_lab, own_lab), want


def fused_move_rows_cuda(lab, w, sig, scal, d_self: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/fused_move_rows.cu``: ``(best int32[R], want bool[R])``."""
    _check_cuda("fused_move_rows", [("lab", lab, torch.int32, 2),
                                    ("w", w, torch.float32, 2),
                                    ("sig", sig, torch.float32, 2),
                                    ("scal", scal, torch.float32, 2)])
    r, d = lab.shape
    if w.shape != lab.shape or sig.shape != lab.shape or \
            scal.shape != (r, 8) or not 0 <= d_self < d:
        raise ValueError(f"fused_move_rows: shapes lab {tuple(lab.shape)} "
                         f"w {tuple(w.shape)} sig {tuple(sig.shape)} scal "
                         f"{tuple(scal.shape)} d_self {d_self}")
    fn = _load("fused_move_rows").fused_move_rows_launch
    best = torch.empty((r,), dtype=torch.int32, device=lab.device)
    want = torch.empty((r,), dtype=torch.bool, device=lab.device)
    with torch.cuda.device(lab.device):   # see row_totals_cuda
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        _count_launch("fused_move_rows", (r, d), lab.device)
        _raise_on("fused_move_rows", fn(
            lab.data_ptr(), w.data_ptr(), sig.data_ptr(), scal.data_ptr(),
            best.data_ptr(), want.data_ptr(), r, d, int(d_self), stream))
    return best, want


def fused_move_rows(lab, w, sig, scal, d_self: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dense move sweep over rows (see csrc/fused_move_rows.cu)."""
    if _on_cpu(lab):
        return fused_move_rows_plain(lab, w, sig, scal, d_self)
    return fused_move_rows_cuda(lab, w, sig, scal, d_self)
