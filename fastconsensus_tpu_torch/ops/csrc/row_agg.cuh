// Row aggregation shared by row_totals.cu and fused_move_rows.cu: for every
// padded row r and slot i
//
//     total[r, i] = sum_j w[r, j] * (lab[r, j] == lab[r, i])
//     head[r, i]  = no j < i with lab[r, j] == lab[r, i], and lab[r, i] != SENTINEL
//
// The sum is always the left fold over the row's matching slots in
// ascending j, each add an explicit __fadd_rn: both regimes below give the
// same bits, for any weights, as a loop `t = t + w[j]` over j = 0..D-1.
//
// Two regimes, cut over at ROW_AGG_FLAT_MAX = 64 slots a row.
//
// * Flat tiles (D <= 64).  A block owns a tile of whole, contiguous rows
//   (up to ROW_AGG_TILE = 4096 slots), so the tile's labels and weights
//   are two contiguous byte ranges.  They are staged in shared memory with
//   16-byte cp.async copies, double-buffered: a persistent grid (three
//   blocks on each SM) walks the tiles and the next tile's copy is in flight
//   while this one is compared.  A thread takes a chunk of 9 or 17 slots of
//   one row, keeps their labels and totals in registers and walks the row's
//   D labels once; every lane is busy at any D.  The compare is D
//   operations a slot, so these tiles are bound by instruction issue, not by
//   the row's bytes, once D passes ~17.
// * Sorted rows (D > 64).  Wide rows are sorted in shared memory instead:
//   32-bit keys (the label's low bits above the slot), a bitonic sort over
//   the next power of two with each thread holding consecutive keys in
//   registers (in-thread and shuffle steps; shared memory only across
//   warps), then each label's run lies in ascending slot order.  One thread
//   folds each run into its total; the run's first key is the head.
//   O(D log^2 D) a row, not D^2.  Rows of up to ROW_AGG_SORT_MAX = 2048
//   slots, the next power of two above the widest dense row (DENSE_D_MAX
//   + 1 = 1025).  32-bit keys, not 64-bit (label << 32 | slot): on an H100
//   the same sort with 64-bit keys ran 1.55x as long at D = 1025, where
//   the steps across warps go through shared memory, and 1.02x at D = 128
//   (chip_smoke.py --phases build,kernels; PERF.md section 6).
// The cut-over: the flat compare grows as D a slot and the sort as
// log^2 D; at the cut the flat tiles still measure faster than the sort one
// slot wider (chip_smoke.py's cut-over rows), and the design's range for it
// was 64 to 128.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define SENTINEL 2147483647
#define ROW_AGG_FLAT_MAX 64
#define ROW_AGG_TILE 4096
#define ROW_AGG_TILE_WORDS (ROW_AGG_TILE + 4)  // room for a 16-byte misalignment
#define ROW_AGG_THREADS 256
#define ROW_AGG_SORT_MAX 2048

// ---------------------------------------------------------------------------
// staging

__device__ __forceinline__ void cp_async4(void* smem, const void* g) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* g) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 4-byte words by which &src[e0] lies past a 16-byte boundary.
__device__ __forceinline__ int stage_pad(const void* src, long long e0) {
    return (int)(((uintptr_t)((const uint32_t*)src + e0) & 15) >> 2);
}

// Copy src[e0, e1) to dst[pad + (e - e0)] (dst 16-byte aligned) with 16-byte
// cp.async where a whole aligned chunk lies inside the range, 4-byte copies
// at its two ends.  Never reads outside [e0, e1).
__device__ __forceinline__ void stage_async(uint32_t* dst, const void* src,
                                            long long e0, long long e1) {
    const int pad = stage_pad(src, e0);
    const uint32_t* g = (const uint32_t*)src + e0 - pad;  // 16-byte aligned
    const int n = (int)(e1 - e0) + pad;
    const int chunks = (n + 3) >> 2;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
        const int lo = c << 2;
        if (lo >= pad && lo + 4 <= n) {
            cp_async16(dst + lo, g + lo);
        } else {
            for (int k = lo; k < lo + 4; ++k)
                if (k >= pad && k < n) cp_async4(dst + k, g + k);
        }
    }
}

// ---------------------------------------------------------------------------
// flat tiles

// Slots a thread takes in the flat regime.  The main path's rows are 8k + 1
// slots (a multiple of 8 neighbour slots and the node's own); chunks of 9
// and 17 hold the two narrowest whole.  A kernel built for chunk C serves
// the widths with flat_chunk(d) == C.
__host__ __device__ __forceinline__ int flat_chunk(int d) { return d <= 9 ? 9 : 17; }

__host__ __device__ __forceinline__ int flat_chunks(int d) {
    return (d + flat_chunk(d) - 1) / flat_chunk(d);
}

// Rows of a flat tile: at most ROW_AGG_TILE slots, and one chunk for each
// thread of the block.
__host__ __device__ __forceinline__ int flat_rows_per_tile(int d) {
    const int by_slots = ROW_AGG_TILE / d;
    const int by_threads = ROW_AGG_THREADS / flat_chunks(d);
    return by_slots < by_threads ? by_slots : by_threads;
}

// Dynamic shared memory of the flat pipeline: two buffers each of labels
// and weights, and the current tile's heads.
#define ROW_AGG_FLAT_HEADS (4 * ROW_AGG_TILE_WORDS * 4)
#define ROW_AGG_FLAT_SMEM (ROW_AGG_FLAT_HEADS + ROW_AGG_TILE)
// Flat blocks resident on an SM: as many as the shared memory holds (3 x
// 69.7 KB of 227 KB), which caps a thread at 85 registers.
#define ROW_AGG_FLAT_BLOCKS 3

// Totals and heads of a staged flat tile, in place: afterwards sw[k] holds
// the total of tile slot k (the rows laid end to end) and s_head[k] its
// head.  Thread u takes chunk u % cpr of row u / cpr (C = flat_chunk(d)
// slots each): the chunk's labels
// and totals stay in registers while the thread walks the row's labels and
// weights in shared memory, j = 0 .. d-1 in order, so each total is the
// left fold in ascending j.  Within the chunk, whether j comes before a
// slot is known at compile time.  Every thread of the block must call this.
template <int C>
__device__ __forceinline__ void flat_tile_totals(const int32_t* sl, float* sw,
                                                 uint8_t* s_head, int rows, int d) {
    const int cpr = (d + C - 1) / C;
    const int u = threadIdx.x;
    const bool act = u < rows * cpr;
    const int r = act ? u / cpr : 0;
    const int c0 = act ? (u - r * cpr) * C : 0;
    const int32_t* rl = sl + r * d;
    const float* rw = sw + r * d;
    int32_t l[C];
    float t[C];
    bool dup[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        l[k] = act && c0 + k < d ? rl[c0 + k] : SENTINEL;
        t[k] = 0.0f;
        dup[k] = false;
    }
    if (act) {
        for (int j = 0; j < c0; ++j) {  // slots before the chunk
            const int32_t lj = rl[j];
            const float wj = rw[j];
#pragma unroll
            for (int k = 0; k < C; ++k) {
                if (l[k] == lj) {
                    t[k] = __fadd_rn(t[k], wj);
                    dup[k] = true;
                }
            }
        }
#pragma unroll
        for (int jj = 0; jj < C; ++jj) {  // the chunk's own slots
            if (c0 + jj < d) {
                const float wj = rw[c0 + jj];
#pragma unroll
                for (int k = 0; k < C; ++k) {
                    if (l[k] == l[jj]) {
                        t[k] = __fadd_rn(t[k], wj);
                        if (jj < k) dup[k] = true;
                    }
                }
            }
        }
        for (int j = c0 + C; j < d; ++j) {  // slots after it
            const int32_t lj = rl[j];
            const float wj = rw[j];
#pragma unroll
            for (int k = 0; k < C; ++k)
                if (l[k] == lj) t[k] = __fadd_rn(t[k], wj);
        }
    }
    __syncthreads();  // every chunk of the row has read its weights
    if (act) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
            if (c0 + k < d) {
                sw[r * d + c0 + k] = t[k];
                s_head[r * d + c0 + k] = (!dup[k] && l[k] != SENTINEL) ? 1 : 0;
            }
        }
    }
    __syncthreads();
}

// Persistent, double-buffered walk over flat tiles of whole rows.  For each
// tile, between block barriers, calls
//     tile_fn(s_lab, s_w, first_row, rows)
// with the tile's rows staged contiguously: s_lab[k], s_w[k] for
// k < rows * d (s_w may be overwritten).  Every thread of the block must
// call this.
template <class TileFn>
__device__ __forceinline__ void flat_tiles(const int32_t* __restrict__ lab,
                                           const float* __restrict__ w,
                                           long long n_rows, int d,
                                           uint32_t* smem, TileFn tile_fn) {
    const int rpt = flat_rows_per_tile(d);
    const long long n_tiles = (n_rows + rpt - 1) / rpt;
    uint32_t* buf_lab[2] = {smem, smem + ROW_AGG_TILE_WORDS};
    uint32_t* buf_w[2] = {smem + 2 * ROW_AGG_TILE_WORDS,
                          smem + 3 * ROW_AGG_TILE_WORDS};
    auto stage = [&](long long tile, int b) {
        const long long r0 = tile * rpt;
        const long long r1 = r0 + rpt < n_rows ? r0 + rpt : n_rows;
        stage_async(buf_lab[b], lab, r0 * d, r1 * d);
        stage_async(buf_w[b], w, r0 * d, r1 * d);
    };
    long long tile = blockIdx.x;
    if (tile < n_tiles) stage(tile, 0);
    cp_async_commit();
    for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
        const int b = it & 1;
        // buffer b ^ 1 was last read in the previous iteration, which ended
        // with a block barrier
        if (tile + gridDim.x < n_tiles) stage(tile + gridDim.x, b ^ 1);
        cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();
        const long long r0 = tile * rpt;
        const int rows = (int)(r0 + rpt < n_rows ? rpt : n_rows - r0);
        tile_fn(reinterpret_cast<const int32_t*>(buf_lab[b] + stage_pad(lab, r0 * d)),
                reinterpret_cast<float*>(buf_w[b] + stage_pad(w, r0 * d)), r0, rows);
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// sorted rows

__host__ __device__ __forceinline__ int sort_width(int d) {  // next power of two
    int n = 1;
    while (n < d) n <<= 1;
    return n;
}

// Threads that sort one row, and rows a block of ROW_AGG_THREADS holds.
// Rows of up to 256 keys take one warp each, so no sort step needs a block
// barrier.  Keys per thread, sort_width(d) / sort_threads_per_row(d), are
// 2, 4 or 8 for rows of up to ROW_AGG_SORT_MAX slots.
__host__ __device__ __forceinline__ int sort_threads_per_row(int d) {
    const int half = sort_width(d) / 2;
    if (half <= 128) return 32;
    return half < ROW_AGG_THREADS ? half : ROW_AGG_THREADS;
}

__host__ __device__ __forceinline__ int sort_rows_per_block(int d) {
    return ROW_AGG_THREADS / sort_threads_per_row(d);
}

// Shared memory a row takes: keys and folded weights (4 B each) per sorted
// position; labels, weights-then-totals (4 B each) and heads (1 B) per slot.
// A block's rows stay under the 48 KB a launch may take without opting in
// (34,816 B at 8 rows of 256 keys or one row of 2048).
__host__ __device__ __forceinline__ size_t sort_row_smem(int d) {
    const size_t n = (size_t)sort_width(d);
    return n * 8 + (((size_t)d * 9 + 15) & ~(size_t)15);
}

// Per-row shared-memory arrays of a sorted-rows block.
struct SortRowSmem {
    uint32_t* keys;
    float* fold;
    int32_t* lab;
    float* w;
    uint8_t* head;
};

__device__ __forceinline__ SortRowSmem sort_row_smem_at(unsigned char* smem,
                                                        int d, int row_in_block) {
    unsigned char* base = smem + (size_t)row_in_block * sort_row_smem(d);
    const size_t n = (size_t)sort_width(d);
    SortRowSmem s;
    s.keys = reinterpret_cast<uint32_t*>(base);
    s.fold = reinterpret_cast<float*>(base + n * 4);
    s.lab = reinterpret_cast<int32_t*>(base + n * 8);
    s.w = reinterpret_cast<float*>(base + n * 8 + (size_t)d * 4);
    s.head = reinterpret_cast<uint8_t*>(base + n * 8 + (size_t)d * 8);
    return s;
}

// Bitonic sort of the n keys of one row in shared memory, by `nt` threads
// holding E = n / nt consecutive keys each in registers.  A step of stride
// below E compares within a thread, one below 32 E across the warp with
// shuffles, and only the longer ones exchange through shared memory (block
// barriers; such steps exist only when a row spans several warps).
template <int E>
__device__ __forceinline__ void bitonic_sort(uint32_t* keys, int n, int gt, int nt) {
    const int p0 = gt * E;
    uint32_t k[E];
#pragma unroll
    for (int e = 0; e < E; ++e) k[e] = keys[p0 + e];
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride >= E; stride >>= 1) {
            const bool smem = stride >= 32 * E;
            if (smem) {
                __syncthreads();  // the previous exchange has been read
#pragma unroll
                for (int e = 0; e < E; ++e) keys[p0 + e] = k[e];
                __syncthreads();
            }
            // stride >= E: position bits at and above it are the thread's
            const bool keep_min = ((p0 & stride) == 0) == ((p0 & size) == 0);
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const uint32_t other = smem ? keys[(p0 + e) ^ stride]
                                            : __shfl_xor_sync(0xffffffffu, k[e], stride / E);
                k[e] = keep_min ? min(k[e], other) : max(k[e], other);
            }
        }
#pragma unroll
        for (int st = E / 2; st >= 1; st >>= 1) {
            if (st >= size) continue;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                if (e & st) continue;
                const uint32_t lo = min(k[e], k[e | st]), hi = max(k[e], k[e | st]);
                const bool up = ((p0 + e) & size) == 0;
                k[e] = up ? lo : hi;
                k[e | st] = up ? hi : lo;
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) keys[p0 + e] = k[e];
    __syncthreads();
}

// One row's totals and heads, computed by the `nt` threads with group-local
// index gt (nt = sort_threads_per_row(d), E = sort_width(d) / nt).
// Leaves total[k] in s.w[k], the head in s.head[k] and the label in
// s.lab[k] for k < d.  `live` is false for a group past the last row: it
// still joins every barrier.  Every thread of the block must call this.
//
// Keys are 32 bits: the label's low 32 - log2(n) bits above the slot.
// Labels that share those bits (rare: never when labels are below 2^21)
// land in one group of sorted keys, which the fold separates by comparing
// the labels themselves.
template <int E>
__device__ __forceinline__ void sort_row_totals(const int32_t* __restrict__ lab_row,
                                                const float* __restrict__ w_row,
                                                bool live, int d, int gt, int nt,
                                                const SortRowSmem& s) {
    const int n = sort_width(d);
    const int sb = __ffs(n) - 1;  // slot bits
    const uint32_t smask = (uint32_t)n - 1;
    for (int k = gt; k < n; k += nt) {
        uint32_t key = ~0u;  // padding: after every real key, whose slot is < n - 1
        if (live && k < d) {
            const int32_t l = lab_row[k];
            s.lab[k] = l;
            s.w[k] = w_row[k];
            key = ((uint32_t)l << sb) | (uint32_t)k;
        }
        s.keys[k] = key;
    }
    __syncthreads();
    bitonic_sort<E>(s.keys, n, gt, nt);
    // Weights in sorted order, contiguous for the folds; and whether two
    // labels share a group of key bits anywhere in the block's rows.
    bool mixed = false;
    for (int p = gt; p < d; p += nt) {
        if (!live) continue;
        const uint32_t key = s.keys[p];
        s.fold[p] = s.w[key & smask];
        if (p > 0 && (s.keys[p - 1] >> sb) == (key >> sb))
            mixed |= s.lab[s.keys[p - 1] & smask] != s.lab[key & smask];
    }
    mixed = __syncthreads_or(mixed);
    // One thread per group of equal key bits, slots ascending in it: fold
    // the group, and write each member's total and head by slot.
    for (int p = gt; p < d; p += nt) {
        if (!live) continue;
        const uint32_t g = s.keys[p] >> sb;
        if (p > 0 && (s.keys[p - 1] >> sb) == g) continue;
        int q = p + 1, hi = d;  // the group ends at the first higher key bits
        while (q < hi) {
            const int mid = (q + hi) >> 1;
            if ((s.keys[mid] >> sb) == g)
                q = mid + 1;
            else
                hi = mid;
        }
        if (!mixed) {
            const int32_t l = s.lab[s.keys[p] & smask];
            float t = 0.0f;
            for (int b = p; b < q; ++b) t = __fadd_rn(t, s.fold[b]);
            for (int b = p; b < q; ++b) {
                const uint32_t slot = s.keys[b] & smask;
                s.w[slot] = t;
                s.head[slot] = (b == p && l != SENTINEL) ? 1 : 0;
            }
            continue;
        }
        // labels that share key bits: one fold per distinct label, from its
        // first member on
        for (int a = p; a < q; ++a) {
            const int32_t l = s.lab[s.keys[a] & smask];
            bool first = true;
            for (int b = p; b < a && first; ++b) first = s.lab[s.keys[b] & smask] != l;
            if (!first) continue;
            float tl = 0.0f;
            for (int b = a; b < q; ++b)
                if (s.lab[s.keys[b] & smask] == l) tl = __fadd_rn(tl, s.fold[b]);
            for (int b = a; b < q; ++b) {
                const uint32_t slot = s.keys[b] & smask;
                if (s.lab[slot] != l) continue;
                s.w[slot] = tl;
                s.head[slot] = (b == a && l != SENTINEL) ? 1 : 0;
            }
        }
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// launch helpers

// Lets `kernel` use `smem` bytes of dynamic shared memory (above 48 KB only
// with this attribute set).
template <class Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

// The persistent grid of `kernel`: the blocks that fit on the card at once,
// no more than `work` of them.  `resident` (one static per kernel, indexed
// by device) caches the count, so a launch makes no query after the first.
template <class Kernel>
static cudaError_t persistent_grid(Kernel kernel, size_t smem, int threads,
                                   long long work, int* resident, long long* grid) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    int all = dev < 64 ? resident[dev] : 0;
    if (all == 0) {
        int sms = 0, per_sm = 0;
        err = allow_smem(kernel, smem);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                smem);
        if (err != cudaSuccess) return err;
        all = sms * (per_sm < 1 ? 1 : per_sm);
        if (dev < 64) resident[dev] = all;
    }
    *grid = all < work ? all : work;
    return cudaSuccess;
}

// Calls launch(std::integral_constant<int, E>()) for the keys per thread E
// that a sorted row of d slots takes; rows past ROW_AGG_SORT_MAX are refused.
template <class Launch>
static cudaError_t dispatch_sort(int d, Launch launch) {
    if (d > ROW_AGG_SORT_MAX) return cudaErrorInvalidValue;
    switch (sort_width(d) / sort_threads_per_row(d)) {
        case 2: return launch(std::integral_constant<int, 2>());
        case 4: return launch(std::integral_constant<int, 4>());
        default: return launch(std::integral_constant<int, 8>());
    }
}
