"""Capture-safe rounds and their CUDA graphs (the fused round block).

The fused round block (``engine.consensus_rounds_block``) runs whole
consensus rounds with no host read and with static shapes, so that on
the card a round is captured once into a CUDA graph and replayed round
after round, with one stats readback a block.  This module holds what
that needs:

* a static flag, :func:`capture_safe` (a context) and :func:`active`: the
  block sets it while it runs or captures a round, and the round's
  modules read it to take their capture-safe variants (the same
  arithmetic as the eager code, no host reads, static shapes);
* :func:`when`, a device-side branch.  Under capture its body becomes the
  body of a conditional IF node (``csrc/graph_cond.cu``) that runs only
  where a bool on the device holds.  Anywhere else (the CPU, or the card
  outside a capture) the body always runs and its results are selected
  under the bool, with no host read either way;
* :func:`sweeping` and :func:`sweeping_members`: the members of a
  batched block's stacked detection whose sweeps run.  The batched block
  (``engine.BatchBlock``) detects every job's members at the stream's
  static shape; a frozen job's members start stopped, so they keep their
  start labels and add no sweep, and the block launches what one batched
  round a host step launches;
* :func:`host_node` and :func:`stage_to_host`: a C function run on the
  host in stream order (``csrc/host_node.cu``; under capture a host node
  of the graph, the port's counterpart of the reference's
  ``jax.pure_callback``), fed by copies into pinned buffers that the
  step registers;
* :class:`CapturedStep`: one capture of a function into a
  ``torch.cuda.CUDAGraph``.  The IF nodes' bodies are captured from
  streams of their own, so their temporaries come from a second memory
  pool of the graph (the first one takes the capture stream's).

A capture that fails raises: nothing falls back to the eager round.
While a step is captured, a host read (``item``, ``bool``, a boolean
mask, a copy to the host) or a device-wide synchronize raises
:class:`CaptureError` before it reaches the card: on the card it would
invalidate the capture, and a capture invalidated inside an IF node's
body cannot be ended safely, which leaves its streams capturing.  The
one exemption is a copy into a pinned staging buffer that
:func:`stage_to_host` registered for this capture: at replay it is a
copy node that a host node after it reads, and the host reads nothing
at capture.

A host node and a copy to or from host memory stay at the top level of
the graph, never inside an IF node's body: CUDA's conditional bodies
admit kernels, copies and memsets of device memory, and nested
conditional, empty and child-graph nodes, not host nodes (CUDA 12.8
refuses one there with ``cudaErrorInvalidValue``).  A host
function that must not run after a block stopped reads its own flag
(staged just before it) and leaves its outputs as they were.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_local = threading.local()
_streams: Dict[Tuple[torch.device, int], "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()
# One capture at a time in the process, and none while a closed graph's
# memory is handed back (the allocator must see no capture then).
_capture_lock = threading.Lock()


class CaptureError(RuntimeError):
    """A CUDA-graph capture or one of its conditional nodes failed."""


def active() -> bool:
    """Is a capture-safe round being run or captured on this thread?"""
    return getattr(_local, "safe", 0) > 0


@contextlib.contextmanager
def capture_safe():
    """Run the enclosed rounds through their capture-safe variants."""
    _local.safe = getattr(_local, "safe", 0) + 1
    try:
        yield
    finally:
        _local.safe -= 1


@contextlib.contextmanager
def sweeping(mask):
    """Within the enclosed detection, sweep only the members ``mask``
    (bool[M] on the device, None: every member) names."""
    prev = getattr(_local, "members", None)
    _local.members = mask
    try:
        yield
    finally:
        _local.members = prev


def sweeping_members(m: int):
    """The mask :func:`sweeping` set for a detection of ``m`` members, or
    None (every member sweeps)."""
    mask = getattr(_local, "members", None)
    if mask is not None and mask.shape != (m,):
        raise ValueError(f"a sweep mask of shape {tuple(mask.shape)} for "
                         f"{m} members")
    return mask


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _child_stream(device: torch.device, depth: int) -> "torch.cuda.Stream":
    """The stream that captures the IF bodies at ``depth`` on ``device``:
    one the library makes, not one of torch's pool, so that a stream a
    failed capture leaves behind is never handed out again."""
    from fastconsensus_tpu_torch.ops import row_kernels

    with _streams_lock:
        s = _streams.get((device, depth))
        if s is None:
            lib = row_kernels._load("graph_cond")
            with torch.cuda.device(device):
                ptr = lib.graph_cond_stream_create()
            if not ptr:
                raise CaptureError("graph_cond_stream_create failed")
            s = torch.cuda.ExternalStream(ptr, device=device)
            _streams[(device, depth)] = s
        return s


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the enclosed work into the body of an IF node on ``pred``
    (a bool scalar on the capturing device): at replay it runs only where
    ``pred`` is true.  Nested nodes capture from one stream per depth."""
    from fastconsensus_tpu_torch.ops import row_kernels

    lib = row_kernels._load("graph_cond")
    dev = pred.device
    pred = pred.reshape(()).to(torch.bool).contiguous()
    keep = getattr(_local, "keep", None)
    if keep is not None:
        keep.append(pred)   # the condition kernel reads it at each replay
    depth = getattr(_local, "if_depth", 0)
    child = _child_stream(dev, depth)
    parent = torch.cuda.current_stream(dev)
    err = lib.graph_cond_if_begin(parent.cuda_stream, pred.data_ptr(),
                                  child.cuda_stream)
    if err != 0:
        raise CaptureError(f"graph_cond_if_begin failed with CUDA error "
                           f"{err}")
    _local.if_depth = depth + 1
    try:
        with torch.cuda.stream(child):
            yield
    except BaseException:
        # the body failed (a host read or a sync in it ends the whole
        # capture): ending the body's capture then is not safe when the
        # capture it belongs to is gone, so the stream is left to it and
        # never used again; the capture raises
        if lib.graph_cond_status(child.cuda_stream) == 1:
            lib.graph_cond_if_end(child.cuda_stream)
        else:
            with _streams_lock:
                _streams.pop((dev, depth), None)
        raise
    finally:
        _local.if_depth = depth
    err = lib.graph_cond_if_end(child.cuda_stream)
    if err != 0:
        raise CaptureError(f"graph_cond_if_end failed with CUDA error {err}")


def when(pred: torch.Tensor, body: Callable[[], Sequence[torch.Tensor]],
         outs: Sequence[torch.Tensor]) -> None:
    """Where the bool scalar ``pred`` holds, run ``body()`` and write its
    results into ``outs`` (in place); else leave ``outs`` as they are.
    Under capture, an IF node; elsewhere the body runs and the results
    are selected under ``pred``."""
    if _capturing(pred):
        with if_node(pred):
            for o, r in zip(outs, body()):
                o.copy_(r)
        return
    for o, r in zip(outs, body()):
        o.copy_(torch.where(pred, r, o))


def _staged(t: torch.Tensor) -> bool:
    """Is ``t`` a whole staging buffer registered for this capture?"""
    staging = getattr(_local, "staging", None)
    return staging is not None and \
        staging.get(t.data_ptr()) == t.numel() * t.element_size()


def stage_to_host(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` (on the card) into ``dst``, a whole pinned host buffer
    that outlives the step, in stream order and without a sync: the input
    of a :func:`host_node` after it.  Under capture it registers ``dst``
    first, the only host copy :class:`_NoHostRead` then admits."""
    if dst.device.type != "cpu" or not dst.is_contiguous():
        raise ValueError(f"a staging buffer is a contiguous host tensor, "
                         f"not {dst.device} {tuple(dst.shape)}")
    staging = getattr(_local, "staging", None)
    if staging is not None:
        staging[dst.data_ptr()] = dst.numel() * dst.element_size()
    dst.copy_(src, non_blocking=True)


class HostBuffers:
    """Pinned host tensors for :func:`stage_to_host` and the host nodes,
    from ``csrc/host_node.cu`` (``cudaHostAlloc``) rather than torch's
    pinned-memory cache, which would record events on the capture stream
    for every copy and again when a tensor is freed, whenever that is.
    :meth:`close` frees them; it must not run during a capture."""

    def __init__(self):
        self._ptrs: list = []

    def empty(self, shape: Sequence[int], dtype: torch.dtype
              ) -> torch.Tensor:
        """A zeroed pinned host tensor of ``shape`` and ``dtype``."""
        import ctypes
        import math

        from fastconsensus_tpu_torch.ops import row_kernels

        n = max(1, math.prod(shape))
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        ptr = row_kernels._load("host_node").host_node_alloc(nbytes)
        if not ptr:
            raise CaptureError(f"host_node_alloc of {nbytes} bytes failed")
        self._ptrs.append(ptr)
        buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        t = torch.frombuffer(buf, dtype=dtype, count=n)
        t.zero_()
        return t[:math.prod(shape)].view(tuple(shape))

    def close(self) -> None:
        """Free every buffer (the tensors made from them must be dropped
        first and no graph may still use them)."""
        from fastconsensus_tpu_torch.ops import row_kernels

        lib = row_kernels._load("host_node") if self._ptrs else None
        while self._ptrs:
            err = lib.host_node_free(self._ptrs.pop())
            if err != 0:
                raise CaptureError(f"host_node_free failed with CUDA "
                                   f"error {err}")


def host_node(fn: int, arg) -> None:
    """Run the C function at address ``fn`` (a ``cudaHostFn_t``, which
    must not call CUDA or take the interpreter's lock) on ``arg`` (a
    ctypes object) on the host, in the current stream's order: under
    capture a host node of the graph, run at every replay; on the card
    outside a capture, once.  The step keeps ``arg`` alive as long as
    its graph."""
    import ctypes

    from fastconsensus_tpu_torch.ops import row_kernels

    lib = row_kernels._load("host_node")
    keep = getattr(_local, "keep", None)
    if keep is not None:
        keep.append(arg)
    stream = torch.cuda.current_stream()
    err = lib.host_node_launch(stream.cuda_stream, fn,
                               ctypes.addressof(arg))
    if err != 0:
        raise CaptureError(f"host_node_launch failed with CUDA error {err}")


class _NoHostRead(TorchDispatchMode):
    """Raise on the ops that read a tensor to the host or size their
    output from its data; a copy into a registered staging buffer
    (:func:`stage_to_host`) is the one host copy let through."""

    BANNED = frozenset(("_local_scalar_dense", "nonzero", "masked_select",
                        "_unique2", "unique_consecutive", "unique_dim",
                        "bincount"))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        to_host = (name == "_to_copy" and kwargs.get("device") is not None
                   and torch.device(kwargs["device"]).type == "cpu") or \
            (name == "copy_" and args[0].device.type == "cpu" and
             args[1].device.type != "cpu")
        if to_host and name == "copy_" and _staged(args[0]):
            to_host = False
        if name in self.BANNED or to_host:
            raise CaptureError(f"a host read ({name}) in a captured round")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _no_sync():
    """While a step is captured (under ``_capture_lock``), make
    ``torch.cuda.synchronize`` raise on the capturing thread; other
    threads and other cards sync as before, and the function is restored
    on exit."""
    orig = torch.cuda.synchronize

    def synchronize(*args, **kwargs):
        if getattr(_local, "capturing", False):
            raise CaptureError("a device synchronize in a captured round")
        return orig(*args, **kwargs)

    torch.cuda.synchronize = synchronize
    try:
        yield
    finally:
        torch.cuda.synchronize = orig


# Devices on which a closed graph's pools are still held in the cache.
_closed_pools: set = set()


def _make_room(device: torch.device) -> None:
    """Before a capture: an allocation inside one cannot empty the cache,
    and the pools of closed graphs stay reserved until it is emptied.  So
    the cache is emptied here when a graph was closed on the device since
    the last capture (its pools would add to the new graph's, which the
    footprint model does not price: ``analysis/entrypoints.py``), or when
    what this process holds reserved and unused is more than the card
    has free.  What the eager rounds left cached stays, and the model
    prices it."""
    idx = device.index
    unused = torch.cuda.memory_reserved(idx) - \
        torch.cuda.memory_allocated(idx)
    if device in _closed_pools or unused > torch.cuda.mem_get_info(idx)[0]:
        torch.cuda.empty_cache()
        _closed_pools.discard(device)


class CapturedStep:
    """``fn`` (no arguments; it reads and writes static tensors) captured
    once on ``device`` under :func:`capture_safe`.  :meth:`replay` runs it
    on the current stream; :meth:`close` frees its graph and pools."""

    def __init__(self, fn: Callable[[], None], device: torch.device):
        from fastconsensus_tpu_torch.ops import row_kernels

        device = row_kernels._indexed(device)
        self.device = device
        row_kernels.device_counts(device)   # made before any capture
        row_kernels._load("graph_cond")
        row_kernels._load("host_node")
        with torch.cuda.device(device):
            # cuBLAS makes its handle at a thread's first product on the
            # device, which a capture refuses (CUBLAS_STATUS_NOT_INITIALIZED)
            torch.cuda.current_blas_handle()
        self.graph = torch.cuda.CUDAGraph()
        self._body_pool = torch.cuda.graph_pool_handle()
        self._keep: list = []
        idx = device.index
        prev_keep = getattr(_local, "keep", None)
        _local.keep = self._keep
        _local.staging = {}
        main = torch.cuda.current_stream(device)
        stream = _child_stream(device, -1)     # the capture stream
        stream.wait_stream(main)
        try:
            with _capture_lock, torch.cuda.device(device), \
                    torch.cuda.stream(stream):
                _make_room(device)
                self.graph.capture_begin(capture_error_mode="thread_local")
                # the IF bodies' streams are not the capture stream: route
                # this thread's allocations to the second pool (the
                # capture stream's still go to the graph's own)
                torch._C._cuda_beginAllocateCurrentThreadToPool(
                    idx, self._body_pool)
                _local.capturing = True
                try:
                    with _no_sync(), capture_safe(), _NoHostRead():
                        fn()
                finally:
                    _local.capturing = False
                    torch._C._cuda_endAllocateToPool(idx, self._body_pool)
                    self.graph.capture_end()
        finally:
            _local.keep = prev_keep
            _local.staging = None
            main.wait_stream(stream)

    def replay(self) -> None:
        self.graph.replay()

    def close(self) -> None:
        """Free the graph and hand its body pool back (the graph's own
        pool goes with the graph); their memory stays in the cache, which
        the next capture on the device empties (:func:`_make_room`)."""
        if self.graph is None:
            return
        with _capture_lock:
            self.graph = None
            self._keep.clear()
            torch._C._cuda_releasePool(self.device.index, self._body_pool)
            _closed_pools.add(self.device)
