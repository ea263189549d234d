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
// from one grid step to the next.  Here runs are independent: one CUDA
// block owns one output sub-tile and loops over its own run's entries in
// work-list order, so every output element is summed in the same order as
// the JAX reference (entries in order, k in order within an entry), in
// fp32 with fused multiply-adds.  Nothing is carried between blocks, so no
// atomics and no second pass.
//
// K1 (destination-major; IP and OP): the grid is (segment, sub-tile).  A
// segment is one run of the schedule; its destination block (ci, cj) comes
// from the host.  Each (bm, bn) output block is cut into sub-tiles of at
// most 64 x 64, so a plan with few runs still puts several blocks on each
// of the 132 SMs.  Each block writes its finished sub-tile straight into the
// zeroed C, cropped to (M, N); a run whose destination row is out of bounds
// (a pad run from pad_schedule) is skipped, as the JAX scatter drops it.
//
// K2 (row panel; Gustavson): one run is one output block row, whose
// (bm, Nb*bn) panel (6.2 MB at N = 12100, bm = 128) does not fit in shared
// memory.  The panel is tiled by columns: the grid is (segment, column
// block, sub-tile), and each block scans its run's entries and adds only
// those whose destination column is its own.
//
// What bounds them on the H100: the products run on the CUDA cores in fp32
// (67 TFLOP/s on the data sheet), not on the tensor cores, to keep fp32
// parity with the reference.  Each work entry moves (bm*bk + bk*bn)*4 bytes
// for 2*bm*bk*bn operations: 8 operations a byte at 32-blocks, below the
// card's 20 fp32 operations a byte of device memory, so small blocks are
// bound by bytes (L2 can absorb the re-reads of shared operand blocks) and
// 128-blocks by operations.  The design stages 16-deep slices of the A and
// B sub-tiles through shared memory and gives each of 256 threads a 4 x 4
// register tile, so each shared-memory load feeds two multiply-adds.  No
// cp.async/TMA pipelining and no wgmma yet: that is later work.
//
// Plain C interface, bound with ctypes: every pointer and the stream are
// void*, and each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TM = 64;         // sub-tile rows per CUDA block
constexpr int TN = 64;         // sub-tile columns per CUDA block
constexpr int TK = 16;         // depth staged through shared memory per step
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

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

// K1: grid (segments, sub-tiles of one (bm, bn) block).
__global__ void __launch_bounds__(THREADS) stream_dest_kernel(
        const float* __restrict__ a, const float* __restrict__ b,
        const int* __restrict__ a_slot, const int* __restrict__ b_slot,
        const int* __restrict__ seg_start, const int* __restrict__ seg_ci,
        const int* __restrict__ seg_cj, int bm, int bk, int bn, int mb,
        float* __restrict__ c, int M, int N) {
    const int s = blockIdx.x;
    const int ci = seg_ci[s];
    if (ci < 0 || ci >= mb) return;             // pad run: dropped
    const Tile t = sub_tile(blockIdx.y, bm, bn);
    const int row0 = ci * bm + t.m0;
    const int col0 = seg_cj[s] * bn + t.n0;
    if (row0 >= M || col0 >= N) return;         // wholly in the padding

    __shared__ float As[TK][TM + 1];
    __shared__ float Bs[TK][TN];
    float acc[4][4] = {};
    const size_t a_stride = (size_t)bm * bk, b_stride = (size_t)bk * bn;
    for (int w = seg_start[s]; w < seg_start[s + 1]; ++w)
        accumulate_pair(a + a_slot[w] * a_stride, b + b_slot[w] * b_stride,
                        bk, bn, t, As, Bs, acc);
    store_tile(c, M, N, row0, col0, t, acc);
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

extern "C" int flexagon_stream_spmm(
        const void* a, const void* b, const void* a_slot, const void* b_slot,
        const void* seg_start, const void* seg_ci, const void* seg_cj,
        int n_seg, int bm, int bk, int bn, int mb, void* c, int M, int N,
        void* stream) {
    const dim3 grid(n_seg, sub_tiles(bm, bn));
    stream_dest_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const int*)a_slot,
        (const int*)b_slot, (const int*)seg_start, (const int*)seg_ci,
        (const int*)seg_cj, bm, bk, bn, mb, (float*)c, M, N);
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
