// A host node for CUDA-graph capture (the host detectors' step of a fused
// round block, ops/capture.py host_node), and the pinned host buffers it
// reads and writes.
//
// cudaLaunchHostFunc is not reachable from torch, so host_node_launch makes
// it callable through ctypes: on a capturing stream it adds a host node to
// the graph, which runs ``fn(arg)`` on the driver's callback thread at every
// replay, after the work before it and before the work after it; on a
// stream that is not capturing it enqueues the call once.  ``fn`` is a
// plain C function of the port's host library
// (native/src/host_detect.cpp: fc_host_detect), which calls no CUDA API.
//
// host_node_alloc / host_node_free are the staging buffers' pinned memory
// (cudaHostAlloc / cudaFreeHost).  They live outside torch's pinned-memory
// cache on purpose: that cache records an event on the stream of every
// copy into its blocks, here the capture stream, and records more when a
// block is freed, which a garbage collection can do in the middle of
// another capture.  These buffers are freed by their block's close(),
// never while a capture runs.  Each entry returns a cudaError_t (0 on
// success) or, for host_node_alloc, a null pointer on failure.

#include <cstddef>

#include <cuda_runtime.h>

extern "C" int host_node_launch(void* stream, void* fn, void* arg) {
    return cudaLaunchHostFunc(static_cast<cudaStream_t>(stream),
                              reinterpret_cast<cudaHostFn_t>(fn), arg);
}

extern "C" void* host_node_alloc(size_t bytes) {
    void* ptr = nullptr;
    if (cudaHostAlloc(&ptr, bytes, cudaHostAllocDefault) != cudaSuccess)
        return nullptr;
    return ptr;
}

extern "C" int host_node_free(void* ptr) { return cudaFreeHost(ptr); }
