"""Host C++ detectors and edgelist parser: build and ctypes bindings.

CNM fast-greedy agglomeration and the Infomap map-equation search are
sequential algorithms with no data-parallel form, so both packages run
them on the host.  The sources in ``src/`` are the port's own copy of the
reference's first-party C++ (``fastconsensus_tpu/native/src``, unchanged,
:data:`SOURCES`) and the port's ``host_detect.cpp`` (:data:`PORT_SOURCES`).
They compile at first use with one ``g++`` process into
``fastconsensus_tpu_torch/_build/``, keyed by a hash of the sources, the
compiler and its flags, and load through :mod:`ctypes` with the
reference's signatures.  No built library is ever committed: one built on
another host can need a newer C++ runtime than this one has.

There is no fallback: when the build fails, :func:`available` is false and
every entry point raises :class:`NativeBuildError` carrying the
compiler's error output.

* :func:`cnm_labels`     — n_p randomized CNM fast-greedy partitions
* :func:`infomap_labels` — n_p Infomap (two-level map equation) partitions
* :func:`parse_edgelist` — single-pass ``u v [w]`` file parser
* :func:`host_detect`    — the host node's step of a round block
  (``src/host_detect.cpp``, the port's own source beside the copies):
  CNM or Infomap for each live job of staged buffers
* :func:`available`      — whether the library built and loaded
* :func:`loaded`         — whether it is loaded, without building it
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fastconsensus_tpu_torch.analysis.recompile_guard import note_build

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("fastgreedy.cpp", "infomap.cpp", "edgelist.cpp")
HEADERS = ("common.hpp",)
# The port's own sources, built into the same library.
PORT_SOURCES = ("host_detect.cpp",)
# The compiler and flags of the build; both are part of the build key.
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


class NativeBuildError(RuntimeError):
    """The host C++ library did not build or load."""


def lib_path() -> Path:
    """Where the library for the current sources, compiler and flags
    lives."""
    h = hashlib.sha256()
    for name in SOURCES + PORT_SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (SRC_DIR / name).read_bytes())
    h.update(" ".join([CXX] + CXX_FLAGS).encode())
    return BUILD_DIR / f"libfcnative_{h.hexdigest()[:16]}.so"


def reset() -> None:
    """Forget the loaded library and any recorded build failure, so the
    next call builds (or loads) again — after ``CXX`` or ``BUILD_DIR``
    changed, for instance."""
    global _lib, _build_error
    with _lock:
        _lib = None
        _build_error = None


def _compile(so_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp)]
    cmd += [str(SRC_DIR / s) for s in SOURCES + PORT_SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            f"{CXX} exit {e.returncode}: {e.stderr.strip()}") from None
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{CXX}: {e}") from None
    os.replace(tmp, so_path)
    note_build("g++:fcnative")


# The detectors fc_host_detect runs, by the native function's name.
HOST_DETECTORS = {"cnm_labels": 0, "infomap_labels": 1}


class HostDetectArgs(ctypes.Structure):
    """``fc_host_detect``'s argument (``src/host_detect.cpp``), field by
    field: the detector, the static sizes, the staged buffers' addresses
    and two counts the C function keeps (``calls``: executions with a job
    to detect; ``detections``: jobs detected)."""

    _fields_ = [("detector", ctypes.c_int32), ("n_jobs", ctypes.c_int32),
                ("n_nodes", ctypes.c_int32), ("n_p", ctypes.c_int32),
                ("capacity", ctypes.c_int64), ("key_words", ctypes.c_int64),
                ("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("weight", ctypes.c_void_p), ("alive", ctypes.c_void_p),
                ("keys", ctypes.c_void_p), ("runs", ctypes.c_void_p),
                ("labels", ctypes.c_void_p), ("calls", ctypes.c_int64),
                ("detections", ctypes.c_int64)]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for fn in (lib.fc_cnm, lib.fc_infomap):
        fn.argtypes = [i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int32,
                       u64p, ctypes.c_int32, i32p]
        fn.restype = None
    lib.fc_parse_edgelist_count.argtypes = [ctypes.c_char_p, i32p]
    lib.fc_parse_edgelist_count.restype = ctypes.c_int64
    lib.fc_parse_edgelist_fill.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.fc_parse_edgelist_fill.restype = None
    lib.fc_host_detect.argtypes = [ctypes.c_void_p]
    lib.fc_host_detect.restype = None
    lib.fc_host_detect_args_size.argtypes = []
    lib.fc_host_detect_args_size.restype = ctypes.c_int64
    if lib.fc_host_detect_args_size() != ctypes.sizeof(HostDetectArgs):
        raise NativeBuildError(
            f"fc_host_detect's argument is "
            f"{lib.fc_host_detect_args_size()} bytes, HostDetectArgs "
            f"{ctypes.sizeof(HostDetectArgs)}")
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built on first use; the lock serializes the one
    compiler run among threads (processes race benignly: each writes its
    own temporary file and renames it into place)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is None:
            so_path = lib_path()
            try:
                if not so_path.exists():
                    # fcheck: ok=blocking-under-lock (the lock exists to
                    # serialize the one compiler run: concurrent first
                    # callers wait for the single build; after it the
                    # bound library returns without blocking)
                    _compile(so_path)
                try:
                    lib = ctypes.CDLL(str(so_path))
                except OSError:
                    # built on another host (a newer C++ runtime, say):
                    # build it here once more
                    so_path.unlink(missing_ok=True)
                    # fcheck: ok=blocking-under-lock (the same one build)
                    _compile(so_path)
                    lib = ctypes.CDLL(str(so_path))
                _lib = _bind(lib)
                return _lib
            except (NativeBuildError, OSError) as e:
                _build_error = str(e)
        raise NativeBuildError(
            f"the host C++ library (CNM, Infomap, edgelist parser) did not "
            f"build: {_build_error}")


def loaded() -> bool:
    """Whether the library is loaded already; never builds."""
    return _lib is not None


def available() -> bool:
    try:
        load()
        return True
    except NativeBuildError:
        return False


def _as_c(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _run_detector(fn_name: str, src, dst, weight, n_nodes: int,
                  seeds) -> np.ndarray:
    lib = load()
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if weight is None:
        weight = np.ones(src.shape[0], dtype=np.float32)
    weight = np.ascontiguousarray(weight, dtype=np.float32)
    seeds = np.ascontiguousarray(seeds, dtype=np.uint64).reshape(-1)
    if not src.shape == dst.shape == weight.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape}, dst {dst.shape} and weight "
                         f"{weight.shape} must be equal-length vectors")
    if src.size and (min(src.min(), dst.min()) < 0 or
                     max(src.max(), dst.max()) >= n_nodes):
        raise ValueError(f"edge endpoints outside 0..{n_nodes - 1}")
    n_p = int(seeds.shape[0])
    out = np.empty((n_p, int(n_nodes)), dtype=np.int32)
    getattr(lib, fn_name)(
        _as_c(src, ctypes.c_int32), _as_c(dst, ctypes.c_int32),
        _as_c(weight, ctypes.c_float), ctypes.c_int64(src.shape[0]),
        ctypes.c_int32(int(n_nodes)), _as_c(seeds, ctypes.c_uint64),
        ctypes.c_int32(n_p), _as_c(out, ctypes.c_int32))
    return out


def cnm_labels(src, dst, weight, n_nodes: int, seeds) -> np.ndarray:
    """n_p randomized CNM fast-greedy partitions, one per 64-bit seed;
    int32[n_p, n_nodes]."""
    return _run_detector("fc_cnm", src, dst, weight, n_nodes, seeds)


def infomap_labels(src, dst, weight, n_nodes: int, seeds) -> np.ndarray:
    """n_p Infomap (two-level map equation) partitions; int32[n_p, N]."""
    return _run_detector("fc_infomap", src, dst, weight, n_nodes, seeds)


def host_detect_fn() -> int:
    """The address of ``fc_host_detect`` (a ``cudaHostFn_t``), for a host
    node of a captured graph."""
    return ctypes.cast(load().fc_host_detect, ctypes.c_void_p).value


def host_detect(args: HostDetectArgs) -> None:
    """Run ``fc_host_detect`` on ``args`` here, on the calling thread."""
    load().fc_host_detect(ctypes.byref(args))


def parse_edgelist(path: str) -> Tuple[np.ndarray, np.ndarray,
                                       Optional[np.ndarray]]:
    """Parse a ``u v [w]`` edgelist: raw ``(u int64[E], v int64[E],
    w float64[E] or None)`` in the file's ids (compaction stays in
    ``utils/io.py``).  Raises ``ValueError`` when the parser rejects the
    file."""
    lib = load()
    saw = ctypes.c_int32(0)
    # the parser keeps the parsed file between its two calls
    with _lock:
        n = lib.fc_parse_edgelist_count(os.fsencode(path), ctypes.byref(saw))
        if n < 0:
            raise ValueError(f"native parse failed for {path}")
        u = np.empty(n, dtype=np.int64)
        v = np.empty(n, dtype=np.int64)
        w = np.empty(n, dtype=np.float64)
        lib.fc_parse_edgelist_fill(
            _as_c(u, ctypes.c_int64), _as_c(v, ctypes.c_int64),
            _as_c(w, ctypes.c_double), ctypes.c_int64(n))
    return u, v, (w if saw.value else None)
