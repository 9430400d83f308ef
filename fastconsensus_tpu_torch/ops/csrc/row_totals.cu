// Per-row label totals and first-occurrence heads for padded candidate rows.
//
// Replaces the Pallas TPU kernel row_totals / _row_totals_kernel
// (fastconsensus_tpu/ops/pallas_kernels.py).  For every row r and slot i
//
//     total[r, i] = sum_j w[r, j] * (lab[r, j] == lab[r, i])
//     head[r, i]  = no j < i with lab[r, j] == lab[r, i], and lab[r, i] != SENTINEL
//
// Slot order is preserved in the output.  The sum is the left fold in
// ascending j (row_agg.cuh), so the bits do not depend on the regime.
//
// What bounds it on an H100: bytes.  It moves 13 bytes a slot (8 in, 5
// out): 28.6 MB for the lfr100k main path's [2,200,000, 17] call, 8.5 us at
// 3.35 TB/s.  Its least work, D * log2(D) operations a row, stays under
// that byte time at every width up to D = 1025.
//
// Design (the aggregation itself is in row_agg.cuh, shared with
// fused_move_rows.cu):
// * D <= 64 (ROW_AGG_FLAT_MAX; the main path's hybrid rows are 9, 17 and
//   25 slots): a persistent grid walks flat tiles of whole rows, staged
//   with 16-byte cp.async copies and double-buffered, so each SM keeps tens
//   of KB of loads in flight; a thread folds a 9- or 17-slot chunk of a row
//   in registers.  The tile's totals and heads land in shared memory and go
//   out in groups of four slots: one float4 of totals and one 32-bit word
//   of heads.
// * D > 64: one bitonic sort of 32-bit (label, slot) keys per row in
//   shared memory and registers, each label's run folded in slot order.
// The cut-over at 64: the flat compare costs D operations a slot, the sort
// about log^2 D; at 64 the flat tiles still measure faster than the sort
// does at 65.  Rows wider than ROW_AGG_SORT_MAX = 2048 are refused.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound with ctypes (plain C entry point).

#include "row_agg.cuh"

template <int C>
__global__ void __launch_bounds__(ROW_AGG_THREADS, ROW_AGG_FLAT_BLOCKS)
row_totals_flat_kernel(const int32_t* __restrict__ lab, const float* __restrict__ w,
                       float* __restrict__ total, uint8_t* __restrict__ head,
                       long long n_rows, int d) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint8_t* s_head = smem + ROW_AGG_FLAT_HEADS;
    flat_tiles(lab, w, n_rows, d, reinterpret_cast<uint32_t*>(smem),
               [&](const int32_t* sl, float* sw, long long r0, int rows) {
        flat_tile_totals<C>(sl, sw, s_head, rows, d);
        // copy out: groups of four slots at output indices that are
        // multiples of 4 go as one float4 and one 32-bit word of heads;
        // `lead` slots before the first group and the tail one at a time
        const long long e0 = r0 * d;  // output index of the tile's slot 0
        const int n = rows * d;
        int lead = (int)((4 - (e0 & 3)) & 3);
        if (lead > n) lead = n;
        const int groups = (n - lead) >> 2;
        const int tail = lead + 4 * groups;
        for (int g = threadIdx.x; g < groups; g += blockDim.x) {
            const int s = lead + 4 * g;
            *reinterpret_cast<float4*>(total + e0 + s) =
                make_float4(sw[s], sw[s + 1], sw[s + 2], sw[s + 3]);
            *reinterpret_cast<uint32_t*>(head + e0 + s) =
                (uint32_t)s_head[s] | (uint32_t)s_head[s + 1] << 8 |
                (uint32_t)s_head[s + 2] << 16 | (uint32_t)s_head[s + 3] << 24;
        }
        for (int x = threadIdx.x; x < lead + (n - tail); x += blockDim.x) {
            const int s = x < lead ? x : tail + (x - lead);
            total[e0 + s] = sw[s];
            head[e0 + s] = s_head[s];
        }
    });
}

template <int E>
__global__ void __launch_bounds__(ROW_AGG_THREADS)
row_totals_sort_kernel(const int32_t* __restrict__ lab, const float* __restrict__ w,
                       float* __restrict__ total, uint8_t* __restrict__ head,
                       long long n_rows, int d) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int nt = sort_threads_per_row(d);
    const int g = threadIdx.x / nt, gt = threadIdx.x % nt;
    const long long row = (long long)blockIdx.x * sort_rows_per_block(d) + g;
    const bool live = row < n_rows;  // a group past the end still joins the barriers
    const long long base = live ? row * d : 0;
    const SortRowSmem s = sort_row_smem_at(smem, d, g);
    sort_row_totals<E>(lab + base, w + base, live, d, gt, nt, s);
    if (!live) return;
    for (int k = gt; k < d; k += nt) {
        total[base + k] = s.w[k];
        head[base + k] = s.head[k];
    }
}

template <int C>
static cudaError_t launch_flat(const void* lab, const void* w, void* total, void* head,
                               long long n_rows, int d, cudaStream_t st) {
    static int resident[64];
    const int rpt = flat_rows_per_tile(d);
    long long grid = 0;
    const cudaError_t err = persistent_grid(row_totals_flat_kernel<C>, ROW_AGG_FLAT_SMEM,
                                            ROW_AGG_THREADS, (n_rows + rpt - 1) / rpt,
                                            resident, &grid);
    if (err != cudaSuccess) return err;
    row_totals_flat_kernel<C><<<(unsigned int)grid, ROW_AGG_THREADS, ROW_AGG_FLAT_SMEM, st>>>(
        (const int32_t*)lab, (const float*)w, (float*)total, (uint8_t*)head, n_rows, d);
    return cudaSuccess;
}

template <int E>
static cudaError_t launch_sort(const void* lab, const void* w, void* total, void* head,
                               long long n_rows, int d, cudaStream_t st) {
    const int rows = sort_rows_per_block(d);
    const size_t smem = (size_t)rows * sort_row_smem(d);  // under 48 KB
    row_totals_sort_kernel<E><<<(unsigned int)((n_rows + rows - 1) / rows), ROW_AGG_THREADS,
                                smem, st>>>(
        (const int32_t*)lab, (const float*)w, (float*)total, (uint8_t*)head, n_rows, d);
    return cudaSuccess;
}

extern "C" int row_totals_launch(const void* lab, const void* w, void* total,
                                 void* head, long long n_rows, int d,
                                 void* stream) {
    if (n_rows <= 0 || d <= 0) return 0;
    // the flat kernel stores total as float4 and head as 32-bit words
    if (((uintptr_t)total & 15) || ((uintptr_t)head & 3) || ((uintptr_t)lab & 3) ||
        ((uintptr_t)w & 3))
        return (int)cudaErrorMisalignedAddress;
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (d > ROW_AGG_FLAT_MAX)
        err = dispatch_sort(d, [&](auto e) {
            return launch_sort<decltype(e)::value>(lab, w, total, head, n_rows, d, st);
        });
    else if (flat_chunk(d) == 9)
        err = launch_flat<9>(lab, w, total, head, n_rows, d, st);
    else
        err = launch_flat<17>(lab, w, total, head, n_rows, d, st);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
