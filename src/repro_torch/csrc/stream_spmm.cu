// The port's two streaming SpMSpM kernels, for Hopper (sm_90a).
//
// K1 stream_dest_kernel replaces the Pallas kernel
//    src/repro/kernels/stream.py:330 _run_kernel (pallas_call at :393),
// K2 stream_panel_kernel replaces
//    src/repro/kernels/stream.py:415 _panel_kernel (pallas_call at :475).
//
// Both walk a StreamSchedule: a flat work list of (A block, B block) pairs,
// cut into runs that each end in one output tile.  The TPU kernels walk the
// whole list on one core, in order, carrying an fp32 accumulator in VMEM
// from one grid step to the next.  Here runs are independent, and every
// output element is summed in a fixed order, in fp32 with fused
// multiply-adds, with no atomics: the same inputs give the same bits on
// every launch.
//
// K1 (destination-major; IP and OP): a segment is one run of the schedule,
// and its destination block (ci, cj) comes from the host.  The host cuts
// each segment's entries into chunks (DeviceSchedule's chunk table, built
// once per plan), so that a plan with few long runs still fills the 132
// SMs: the 4-token FFN down projection's 12 runs of 35 entries become 108
// chunks.  The grid is (chunk, sub-tile of one (bm, bn) block).  One CUDA
// block sums its chunk's entries in work-list order, k in order within an
// entry.  A segment of one chunk writes its sub-tile straight into the
// zeroed C, cropped to (M, N); a segment of several writes each chunk's
// partial tile to a workspace slot, and stream_reduce_kernel, the second
// pass of the same K1 call, sums the slots in chunk order and writes C.  A
// run whose destination row is out of bounds (a pad run from pad_schedule)
// is skipped, as the JAX scatter drops it.
//
// The sub-tile is TM x 64 with TM = 16, 32 or 64, chosen by the host as the
// least that covers a block's valid rows, min(bm, M): 4 decode tokens in a
// 128-row block compute 16 rows, not 64.  Rows past M are neither loaded
// nor written.  The A and B slices of the chunk's entries stream through a
// ring of STAGES shared-memory slots, each 32 deep, filled with cp.async
// (16-byte copies where rows are 16-byte aligned, else 4-byte ones) while
// the block multiplies the slot that has landed, so the next slices' loads
// are in flight during the current slice's FMAs, across entry boundaries.
//
// K2 (row panel; Gustavson): one run is one output block row, whose
// (bm, Nb*bn) panel (6.2 MB at N = 12100, bm = 128) does not fit in shared
// memory.  The panel is tiled by columns: the grid is (segment, column
// block, 64 x 64 sub-tile), and each block scans its run's entries and adds
// only those whose destination column is its own, staging 16-deep slices
// through shared memory with nothing in flight during the FMAs.  Its
// redesign (the scan, and the pipelined loads of K1) is later work.
//
// What bounds them on the H100: the products run on the CUDA cores in fp32
// (67 TFLOP/s on the data sheet), not on the tensor cores, to keep fp32
// parity with the reference.  Each work entry moves (bm*bk + bk*bn)*4 bytes
// for 2*bm*bk*bn operations: 8 operations a byte at 32-blocks, below the
// card's 20 fp32 operations a byte of device memory, so small blocks and
// few valid rows (decode) are bound by bytes, full 128-blocks by
// operations.  Each of 256 threads keeps a (TM/16) x 4 register tile, and
// reads A four k at a time from shared memory.
//
// Plain C interface, bound with ctypes: every pointer and the stream are
// void*, and each entry returns the first CUDA error of its launches.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads, both kernels

// -- K2's tiling and staging -------------------------------------------------

constexpr int TM = 64;         // sub-tile rows per CUDA block
constexpr int TN = 64;         // sub-tile columns per CUDA block
constexpr int TK = 16;         // depth staged through shared memory per step

struct Tile {
    int m0, n0;   // sub-tile origin inside the (bm, bn) output block
    int tm, tn;   // sub-tile extent (ragged at the block's edge)
};

__device__ __forceinline__ Tile sub_tile(int sub, int bm, int bn) {
    const int tiles_n = (bn + TN - 1) / TN;
    Tile t;
    t.m0 = (sub / tiles_n) * TM;
    t.n0 = (sub % tiles_n) * TN;
    t.tm = min(TM, bm - t.m0);
    t.tn = min(TN, bn - t.n0);
    return t;
}

// acc += A_blk[m0:m0+tm, :] @ B_blk[:, n0:n0+tn], k in order.
// A_blk is (bm, bk) and B_blk is (bk, bn), both row-major.
__device__ __forceinline__ void accumulate_pair(
        const float* __restrict__ a_blk, const float* __restrict__ b_blk,
        int bk, int bn, const Tile& t,
        float (*As)[TM + 1], float (*Bs)[TN], float (&acc)[4][4]) {
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    for (int k0 = 0; k0 < bk; k0 += TK) {
#pragma unroll
        for (int i = 0; i < (TM * TK) / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / TK, k = idx % TK;
            As[k][r] = (r < t.tm && k0 + k < bk)
                ? a_blk[(size_t)(t.m0 + r) * bk + k0 + k] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < (TN * TK) / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int k = idx / TN, c = idx % TN;
            Bs[k][c] = (c < t.tn && k0 + k < bk)
                ? b_blk[(size_t)(k0 + k) * bn + t.n0 + c] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
}

__device__ __forceinline__ void store_tile(
        float* __restrict__ c, int M, int N, int row0, int col0,
        const Tile& t, float (&acc)[4][4]) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= t.tm || row0 + r >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int cc = tx + 16 * j;
            if (cc < t.tn && col0 + cc < N)
                c[(size_t)(row0 + r) * N + col0 + cc] = acc[i][j];
        }
    }
}

// -- K1 ----------------------------------------------------------------------

constexpr int K1_TN = 64;            // sub-tile columns
constexpr int K1_TK = 32;            // depth of one pipeline slice
constexpr int K1_STAGES = 4;         // ring slots: 3 slices in flight
constexpr int K1_LDA = K1_TK + 4;    // A slot row stride (floats): float4
                                     // reads of two rows hit other banks

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
// global -> shared, zero-filled when !ok (nothing is read then)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <int RI>
constexpr int k1_smem_bytes() {
    return K1_STAGES * (16 * RI * K1_LDA + K1_TK * K1_TN) * 4;
}

// K1: grid (chunks, row sub-tiles x column sub-tiles of one (bm, bn)
// block); sub-tiles are (16 RI) x 64.  vec: 16-byte copies are aligned.
template <int RI>
__global__ void __launch_bounds__(THREADS) stream_dest_kernel(
        const float* __restrict__ a, const float* __restrict__ b,
        const int* __restrict__ a_slot, const int* __restrict__ b_slot,
        const int* __restrict__ chunk_start, const int* __restrict__ chunk_seg,
        const int* __restrict__ chunk_slot, const int* __restrict__ seg_ci,
        const int* __restrict__ seg_cj, int bm, int bk, int bn, int mb,
        int tiles_n, int vec, float* __restrict__ c,
        float* __restrict__ part, int M, int N) {
    constexpr int TM_ = 16 * RI;
    constexpr int A_STAGE = TM_ * K1_LDA, B_STAGE = K1_TK * K1_TN;
    extern __shared__ __align__(16) float k1_smem[];
    float* as = k1_smem;
    float* bs = k1_smem + K1_STAGES * A_STAGE;

    const int ch = blockIdx.x;
    const int s = chunk_seg[ch];
    const int ci = seg_ci[s];
    if (ci < 0 || ci >= mb) return;             // pad run: dropped
    const int m0 = (blockIdx.y / tiles_n) * TM_;
    const int n0 = (blockIdx.y % tiles_n) * K1_TN;
    const int row0 = ci * bm + m0;
    const int col0 = seg_cj[s] * bn + n0;
    if (m0 >= bm || row0 >= M || col0 >= N) return;  // wholly in the padding
    // the rows and columns that reach C; B loads whole 4-float chunks,
    // which stay inside the block when bn % 4 == 0
    const int tm = min(min(TM_, bm - m0), M - row0);
    const int tn = min(min(K1_TN, bn - n0), N - col0);

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int w0 = chunk_start[ch];
    const int per = (bk + K1_TK - 1) / K1_TK;   // slices per entry
    const int nsl = (chunk_start[ch + 1] - w0) * per;
    const size_t a_stride = (size_t)bm * bk, b_stride = (size_t)bk * bn;

    // slice t of the chunk (entry t / per, depth (t % per) * K1_TK) -> slot
    auto load = [&](int slot, int t) {
        const int w = w0 + t / per, k0 = (t % per) * K1_TK;
        const float* ab = a + a_slot[w] * a_stride + (size_t)m0 * bk;
        const float* bb = b + b_slot[w] * b_stride + n0;
        float* ad = as + slot * A_STAGE;
        float* bd = bs + slot * B_STAGE;
        for (int q = tid; q < TM_ * (K1_TK / 4); q += THREADS) {
            const int r = q / (K1_TK / 4), k = (q % (K1_TK / 4)) * 4;
            const float* src = ab + (size_t)r * bk + k0 + k;
            float* dst = ad + r * K1_LDA + k;
            if (vec) {
                const bool ok = r < tm && k0 + k < bk;
                cp_async16(dst, ok ? src : ab, ok);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = r < tm && k0 + k + e < bk;
                    cp_async4(dst + e, ok ? src + e : ab, ok);
                }
            }
        }
        for (int q = tid; q < K1_TK * (K1_TN / 4); q += THREADS) {
            const int k = q / (K1_TN / 4), cc = (q % (K1_TN / 4)) * 4;
            const float* src = bb + (size_t)(k0 + k) * bn + cc;
            float* dst = bd + k * K1_TN + cc;
            if (vec) {
                const bool ok = k0 + k < bk && cc < tn;
                cp_async16(dst, ok ? src : bb, ok);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = k0 + k < bk && cc + e < tn;
                    cp_async4(dst + e, ok ? src + e : bb, ok);
                }
            }
        }
    };

    float acc[RI][4] = {};
#pragma unroll
    for (int t = 0; t < K1_STAGES - 1; ++t) {
        if (t < nsl) load(t, t);
        cp_async_commit();
    }
    for (int t = 0; t < nsl; ++t) {
        cp_async_wait<K1_STAGES - 2>();         // slice t has landed
        __syncthreads();                        // ... and slot t-1 is free
        const int next = t + K1_STAGES - 1;
        if (next < nsl) load(next % K1_STAGES, next);
        cp_async_commit();

        const float* ad = as + (t % K1_STAGES) * A_STAGE;
        const float* bd = bs + (t % K1_STAGES) * B_STAGE;
#pragma unroll
        for (int kk = 0; kk < K1_TK; kk += 4) {
            float4 av[RI];
#pragma unroll
            for (int i = 0; i < RI; ++i)
                av[i] = *reinterpret_cast<const float4*>(
                    ad + (ty + 16 * i) * K1_LDA + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float bv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    bv[j] = bd[(kk + q) * K1_TN + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    const float ak = q == 0 ? av[i].x : q == 1 ? av[i].y
                                   : q == 2 ? av[i].z : av[i].w;
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(ak, bv[j], acc[i][j]);
                }
            }
        }
    }
    cp_async_wait<0>();

    // a segment of one chunk writes C; else this chunk's workspace slot
    const int slot = chunk_slot[ch];
    float* dst = slot < 0
        ? c + (size_t)row0 * N + col0
        : part + (size_t)slot * bm * bn + (size_t)m0 * bn + n0;
    const size_t ld = slot < 0 ? (size_t)N : (size_t)bn;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        if (r >= tm) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int cc = tx + 16 * j;
            if (cc < tn) dst[r * ld + cc] = acc[i][j];
        }
    }
}

// K1's second pass: grid (split segments, element blocks of one (bm, bn)
// block, grid-stride).  Each element of a split segment's tile is its
// chunks' slots summed in chunk order.
__global__ void __launch_bounds__(THREADS) stream_reduce_kernel(
        const float* __restrict__ part, const int* __restrict__ split_seg,
        const int* __restrict__ split_start, const int* __restrict__ seg_ci,
        const int* __restrict__ seg_cj, int bm, int bn, int mb,
        float* __restrict__ c, int M, int N) {
    const int p = blockIdx.x;
    const int s = split_seg[p];
    const int ci = seg_ci[s];
    if (ci < 0 || ci >= mb) return;
    const size_t tile = (size_t)bm * bn;
    for (size_t idx = (size_t)blockIdx.y * THREADS + threadIdx.x; idx < tile;
         idx += (size_t)gridDim.y * THREADS) {
        const int row = ci * bm + (int)(idx / bn);
        const int col = seg_cj[s] * bn + (int)(idx % bn);
        if (row >= M || col >= N) continue;
        float sum = 0.0f;
        for (int q = split_start[p]; q < split_start[p + 1]; ++q)
            sum += part[q * tile + idx];
        c[(size_t)row * N + col] = sum;
    }
}

template <int RI>
int launch_dest(const void* a, const void* b, const void* a_slot,
                const void* b_slot, const void* chunk_start,
                const void* chunk_seg, const void* chunk_slot,
                const void* seg_ci, const void* seg_cj, void* part,
                int n_chunk, int bm, int bk, int bn, int mb, void* c, int M,
                int N, cudaStream_t stream) {
    constexpr int smem = k1_smem_bytes<RI>();
    auto kernel = stream_dest_kernel<RI>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles_m = (min(bm, M) + 16 * RI - 1) / (16 * RI);
    const int tiles_n = (bn + K1_TN - 1) / K1_TN;
    const int vec = bk % 4 == 0 && bn % 4 == 0 && (uintptr_t)a % 16 == 0
        && (uintptr_t)b % 16 == 0;
    const dim3 grid(n_chunk, tiles_m * tiles_n);
    kernel<<<grid, THREADS, smem, stream>>>(
        (const float*)a, (const float*)b, (const int*)a_slot,
        (const int*)b_slot, (const int*)chunk_start, (const int*)chunk_seg,
        (const int*)chunk_slot, (const int*)seg_ci, (const int*)seg_cj, bm,
        bk, bn, mb, tiles_n, vec, (float*)c, (float*)part, M, N);
    return (int)cudaGetLastError();
}

// K2: grid (segments, column blocks, sub-tiles of one (bm, bn) block).
__global__ void __launch_bounds__(THREADS) stream_panel_kernel(
        const float* __restrict__ a, const float* __restrict__ b,
        const int* __restrict__ a_slot, const int* __restrict__ b_slot,
        const int* __restrict__ cj, const int* __restrict__ seg_start,
        const int* __restrict__ seg_ci, int bm, int bk, int bn, int mb,
        float* __restrict__ c, int M, int N) {
    const int s = blockIdx.x;
    const int ci = seg_ci[s];
    if (ci < 0 || ci >= mb) return;             // pad run: dropped
    const int col_blk = blockIdx.y;
    const Tile t = sub_tile(blockIdx.z, bm, bn);
    const int row0 = ci * bm + t.m0;
    const int col0 = col_blk * bn + t.n0;
    if (row0 >= M || col0 >= N) return;         // wholly in the padding

    __shared__ float As[TK][TM + 1];
    __shared__ float Bs[TK][TN];
    float acc[4][4] = {};
    bool touched = false;
    const size_t a_stride = (size_t)bm * bk, b_stride = (size_t)bk * bn;
    for (int w = seg_start[s]; w < seg_start[s + 1]; ++w) {
        if (cj[w] != col_blk) continue;         // uniform across the block
        touched = true;
        accumulate_pair(a + a_slot[w] * a_stride, b + b_slot[w] * b_stride,
                        bk, bn, t, As, Bs, acc);
    }
    if (touched) store_tile(c, M, N, row0, col0, t, acc);  // else C stays 0
}

inline int sub_tiles(int bm, int bn) {
    return ((bm + TM - 1) / TM) * ((bn + TN - 1) / TN);
}

}  // namespace

// K1.  rows (16, 32 or 64): the sub-tile's row extent, from the wrapper.
// The chunk table and the split table come from DeviceSchedule; part holds
// one (bm, bn) fp32 slot per chunk of a split segment (null when n_split is
// 0, and then the second pass does not run).
extern "C" int flexagon_stream_spmm(
        const void* a, const void* b, const void* a_slot, const void* b_slot,
        const void* chunk_start, const void* chunk_seg, const void* chunk_slot,
        const void* seg_ci, const void* seg_cj, const void* split_seg,
        const void* split_start, void* part, int n_chunk, int n_split,
        int rows, int bm, int bk, int bn, int mb, void* c, int M, int N,
        void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (n_split > 0 && part == nullptr) return (int)cudaErrorInvalidValue;
    int err;
    if (rows == 16)
        err = launch_dest<1>(a, b, a_slot, b_slot, chunk_start, chunk_seg,
                             chunk_slot, seg_ci, seg_cj, part, n_chunk, bm,
                             bk, bn, mb, c, M, N, s);
    else if (rows == 32)
        err = launch_dest<2>(a, b, a_slot, b_slot, chunk_start, chunk_seg,
                             chunk_slot, seg_ci, seg_cj, part, n_chunk, bm,
                             bk, bn, mb, c, M, N, s);
    else if (rows == 64)
        err = launch_dest<4>(a, b, a_slot, b_slot, chunk_start, chunk_seg,
                             chunk_slot, seg_ci, seg_cj, part, n_chunk, bm,
                             bk, bn, mb, c, M, N, s);
    else
        return (int)cudaErrorInvalidValue;
    if (err || n_split == 0) return err;
    const long long elem_blocks = ((long long)bm * bn + THREADS - 1) / THREADS;
    const dim3 grid(n_split, (unsigned)(elem_blocks < 1024 ? elem_blocks
                                                           : 1024));
    stream_reduce_kernel<<<grid, THREADS, 0, s>>>(
        (const float*)part, (const int*)split_seg, (const int*)split_start,
        (const int*)seg_ci, (const int*)seg_cj, bm, bn, mb, (float*)c, M, N);
    return (int)cudaGetLastError();
}

extern "C" int flexagon_stream_panel_spmm(
        const void* a, const void* b, const void* a_slot, const void* b_slot,
        const void* cj, const void* seg_start, const void* seg_ci,
        int n_seg, int nb, int bm, int bk, int bn, int mb, void* c, int M,
        int N, void* stream) {
    const dim3 grid(n_seg, nb, sub_tiles(bm, bn));
    stream_panel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const int*)a_slot,
        (const int*)b_slot, (const int*)cj, (const int*)seg_start,
        (const int*)seg_ci, bm, bk, bn, mb, (float*)c, M, N);
    return (int)cudaGetLastError();
}

extern "C" const char* flexagon_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
