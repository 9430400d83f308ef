// One whole dense Louvain move sweep per padded row.
//
// Replaces the Pallas TPU kernel fused_move_rows / _fused_move_kernel and
// its _hash_jitter (fastconsensus_tpu/ops/pallas_kernels.py).  Row layout:
// slots 0..d_self-1 are neighbour labels (SENTINEL = empty), slot d_self is
// the node's own zero-weight candidate.  scal[r] = [k_i, coef, jitter scale,
// margin, salt, row id, 0, 0].  Per row:
//
//     total, head        as in row_totals.cu (row_agg.cuh)
//     gain[i]  = total[i] - coef * (sig[i] - [lab[i] == own] * k_i)
//     score[i] = gain[i] + jitter(row id, i, salt) * jscale   (head & real)
//     best     = label of the max score, ties toward the larger label
//     stay     = max gain over the own-label head
//     want     = has & best != own & best_score > stay + margin
//
// Every float operation carries an explicit _rn intrinsic, so nvcc
// contracts no multiply-add into an FMA: the kernel rounds each product and
// sum as the plain PyTorch version does, and agrees with it bit for bit.
// The jitter is the reference's exact uint32 multiply-xorshift (row id
// f32 -> i32 -> u32, wrapping multiplies, >> 9, times 2^-23).  The salt is
// read per row: rows of different ensemble members carry different salts.
//
// What bounds it on an H100: bytes, 12 a slot in (labels, weights, sigma)
// and 37 a row (32 in, 5 out); its least work, D * log2(D) for the
// totals plus ~20 operations a slot for gain, jitter and argmax, stays
// under that byte time.
//
// Design: the totals come from row_agg.cuh, the same code as row_totals.cu,
// in the same two regimes cut over at D = 64 (the flat compare costs D
// operations a slot, the sort about log^2 D); both leave the totals and
// heads in shared memory.  Then one warp per row reads them with sigma
// from global memory, takes a lane-local argmax over its slots, and
// reduces across the warp with shuffles.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound with ctypes (plain C entry point).

#include <math.h>

#include "row_agg.cuh"

__device__ __forceinline__ float hash_jitter(uint32_t row, uint32_t slot,
                                             uint32_t salt) {
    uint32_t m = row * 0x9E3779B1u + slot * 0x85EBCA77u + salt;
    m ^= m >> 15;
    m *= 0x2C1B3C6Du;
    m ^= m >> 13;
    return __fmul_rn((float)(int32_t)(m >> 9), 1.1920928955078125e-07f);
}

// (score, label) pair order: larger score wins, ties toward the larger label.
__device__ __forceinline__ bool better(float s, int32_t l, float bs, int32_t bl) {
    return s > bs || (s == bs && l > bl);
}

// The move decision of one row, by one whole warp, from the row's labels,
// totals and heads (in shared or global memory).
__device__ __forceinline__ void move_row(int lane, long long row, int d, int d_self,
                                         const int32_t* rl, const float* rt,
                                         const uint8_t* rh,
                                         const float* __restrict__ sig,
                                         const float* __restrict__ scal,
                                         int32_t* __restrict__ best_out,
                                         uint8_t* __restrict__ want_out) {
    const long long base = row * (long long)d;
    const float* sc = scal + row * 8;
    const float k_i = sc[0], coef = sc[1], jscale = sc[2], margin = sc[3];
    const uint32_t salt = (uint32_t)(int32_t)sc[4];
    const uint32_t rid = (uint32_t)(int32_t)sc[5];
    const int32_t own_lab = rl[d_self];
    const float neg = -INFINITY;

    float b_score = neg;
    int32_t b_lab = -1;
    float stay = neg;
    for (int i = lane; i < d; i += 32) {
        if (!rh[i]) continue;  // not the label's first slot, or SENTINEL
        const int32_t li = rl[i];
        const bool own = li == own_lab;
        const float x = __fsub_rn(sig[base + i], own ? k_i : 0.0f);
        const float gain = __fsub_rn(rt[i], __fmul_rn(coef, x));
        const float score = __fadd_rn(
            gain, __fmul_rn(hash_jitter(rid, (uint32_t)i, salt), jscale));
        if (better(score, li, b_score, b_lab)) {
            b_score = score;
            b_lab = li;
        }
        if (own) stay = fmaxf(stay, gain);
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, b_score, off);
        const int32_t ol = __shfl_xor_sync(0xffffffffu, b_lab, off);
        if (better(os, ol, b_score, b_lab)) {
            b_score = os;
            b_lab = ol;
        }
        stay = fmaxf(stay, __shfl_xor_sync(0xffffffffu, stay, off));
    }
    if (lane == 0) {
        const bool has = b_score > neg;
        const bool want = has && b_lab != own_lab &&
                          b_score > __fadd_rn(stay, margin);
        best_out[row] = has ? b_lab : own_lab;
        want_out[row] = want ? 1 : 0;
    }
}

template <int C>
__global__ void __launch_bounds__(ROW_AGG_THREADS, ROW_AGG_FLAT_BLOCKS)
fused_move_flat_kernel(const int32_t* __restrict__ lab, const float* __restrict__ w,
                       const float* __restrict__ sig, const float* __restrict__ scal,
                       int32_t* __restrict__ best_out, uint8_t* __restrict__ want_out,
                       long long n_rows, int d, int d_self) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint8_t* s_head = smem + ROW_AGG_FLAT_HEADS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    flat_tiles(lab, w, n_rows, d, reinterpret_cast<uint32_t*>(smem),
               [&](const int32_t* sl, float* sw, long long r0, int rows) {
        flat_tile_totals<C>(sl, sw, s_head, rows, d);
        for (int r = warp; r < rows; r += warps)
            move_row(lane, r0 + r, d, d_self, sl + r * d, sw + r * d, s_head + r * d,
                     sig, scal, best_out, want_out);
    });
}

template <int E>
__global__ void __launch_bounds__(ROW_AGG_THREADS)
fused_move_sort_kernel(const int32_t* __restrict__ lab, const float* __restrict__ w,
                       const float* __restrict__ sig, const float* __restrict__ scal,
                       int32_t* __restrict__ best_out, uint8_t* __restrict__ want_out,
                       long long n_rows, int d, int d_self) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int nt = sort_threads_per_row(d);
    const int g = threadIdx.x / nt, gt = threadIdx.x % nt;
    const long long row = (long long)blockIdx.x * sort_rows_per_block(d) + g;
    const bool live = row < n_rows;
    const long long base = live ? row * d : 0;
    const SortRowSmem s = sort_row_smem_at(smem, d, g);
    sort_row_totals<E>(lab + base, w + base, live, d, gt, nt, s);
    if (live && gt < 32)  // the group's first warp decides the move
        move_row(gt, row, d, d_self, s.lab, s.w, s.head, sig, scal, best_out, want_out);
}

template <int C>
static cudaError_t launch_flat(const void* lab, const void* w, const void* sig,
                               const void* scal, void* best, void* want, long long n_rows,
                               int d, int d_self, cudaStream_t st) {
    static int resident[64];
    const int rpt = flat_rows_per_tile(d);
    long long grid = 0;
    const cudaError_t err = persistent_grid(fused_move_flat_kernel<C>, ROW_AGG_FLAT_SMEM,
                                            ROW_AGG_THREADS, (n_rows + rpt - 1) / rpt,
                                            resident, &grid);
    if (err != cudaSuccess) return err;
    fused_move_flat_kernel<C><<<(unsigned int)grid, ROW_AGG_THREADS, ROW_AGG_FLAT_SMEM, st>>>(
        (const int32_t*)lab, (const float*)w, (const float*)sig, (const float*)scal,
        (int32_t*)best, (uint8_t*)want, n_rows, d, d_self);
    return cudaSuccess;
}

template <int E>
static cudaError_t launch_sort(const void* lab, const void* w, const void* sig,
                               const void* scal, void* best, void* want, long long n_rows,
                               int d, int d_self, cudaStream_t st) {
    const int rows = sort_rows_per_block(d);
    const size_t smem = (size_t)rows * sort_row_smem(d);  // under 48 KB
    fused_move_sort_kernel<E><<<(unsigned int)((n_rows + rows - 1) / rows), ROW_AGG_THREADS,
                                smem, st>>>(
        (const int32_t*)lab, (const float*)w, (const float*)sig, (const float*)scal,
        (int32_t*)best, (uint8_t*)want, n_rows, d, d_self);
    return cudaSuccess;
}

extern "C" int fused_move_rows_launch(const void* lab, const void* w,
                                      const void* sig, const void* scal,
                                      void* best, void* want,
                                      long long n_rows, int d, int d_self,
                                      void* stream) {
    if (n_rows <= 0 || d <= 0) return 0;
    if (((uintptr_t)lab & 3) || ((uintptr_t)w & 3)) return (int)cudaErrorMisalignedAddress;
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (d > ROW_AGG_FLAT_MAX)
        err = dispatch_sort(d, [&](auto e) {
            return launch_sort<decltype(e)::value>(lab, w, sig, scal, best, want, n_rows, d,
                                                   d_self, st);
        });
    else if (flat_chunk(d) == 9)
        err = launch_flat<9>(lab, w, sig, scal, best, want, n_rows, d, d_self, st);
    else
        err = launch_flat<17>(lab, w, sig, scal, best, want, n_rows, d, d_self, st);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
