// Conditional IF nodes for CUDA-graph capture (the fused round block,
// ops/capture.py).
//
// PyTorch's CUDAGraph records a straight line of work.  A fused round
// block needs device-side branches (the sweep loop's exit, a cold or warm
// round, closure or skip), so a captured body is wrapped in an IF node
// whose condition a one-thread kernel sets from a bool on the device at
// replay time: the body runs only where the bool is true, and nothing is
// read back to the host.
//
// graph_cond_if_begin(parent, pred, child): on the capturing stream
// ``parent``, record the condition kernel for ``*pred``, add an IF node
// after the stream's current dependencies, make the node the stream's only
// dependency, and start capturing ``child`` (an idle stream) into the
// node's body graph.  graph_cond_if_end(child) ends that capture.  Both
// return a cudaError_t (0 on success); begin returns -1 when ``parent`` is
// not capturing.  graph_cond_status(stream) is the stream's capture status
// (0 none, 1 active, 2 invalidated; a negative cudaError_t on failure),
// and graph_cond_stream_create() makes a non-blocking stream of the
// current device for the bodies (0 on failure).

#include <cuda_runtime.h>

__global__ void graph_cond_set_kernel(cudaGraphConditionalHandle handle,
                                      const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int graph_cond_if_begin(void* parent, const void* pred,
                                   void* child) {
    cudaStream_t s = static_cast<cudaStream_t>(parent);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                               &deps, &n_deps);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return -1;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    graph_cond_set_kernel<<<1, 1, 0, s>>>(handle,
                                          static_cast<const bool*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                   &n_deps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(
        s, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
    return cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
        nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_cond_if_end(void* child) {
    cudaGraph_t body;
    return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}

extern "C" int graph_cond_status(void* stream) {
    cudaStreamCaptureStatus status;
    cudaError_t err = cudaStreamIsCapturing(static_cast<cudaStream_t>(stream),
                                            &status);
    return err != cudaSuccess ? -static_cast<int>(err)
                              : static_cast<int>(status);
}

extern "C" void* graph_cond_stream_create() {
    cudaStream_t s = nullptr;
    if (cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking) != cudaSuccess)
        return nullptr;
    return s;
}
