// The port's grouped matmul for Mixture-of-Experts expert compute, for
// Hopper (sm_90a).
//
// K3 gmm_kernel replaces the Pallas kernel
//    src/repro/kernels/moe_gmm.py:31 _kernel (pallas_call at :68),
// launched there by gmm (:41).
//
// It computes out[t*bm:(t+1)*bm] = x[t*bm:(t+1)*bm] @ w[group_ids[t]]: rows
// are sorted by group and padded per group to the row tile bm, so every row
// tile multiplies one group's (K, N) weight slab.  The TPU kernel's grid is
// (row tile, column tile, k tile) with the k axis sequential, carrying an
// fp32 accumulator in VMEM from one k step to the next.  Here one CUDA block
// owns one output tile of (at most 64 rows of one row tile) x (64 columns)
// and loops over all of K itself, in order, summing in fp32 with fused
// multiply-adds.  Output tiles are independent: no atomics, no second pass.
//
// Row tiles whose group id is negative (or not below G) are idle: the
// device form of pad_groups gives the tiles past the real count that marker,
// since it sizes the row space by a static bound and never asks the host for
// the real count.  An idle tile reads nothing and writes zeros.
//
// The block's row extent follows bm: 16 rows (one per thread row) when
// bm <= 16, as in decode, where 32 routed rows spread over up to 32 groups;
// else 64 rows (four per thread row), with ragged sub-tiles masked, so any
// bm that gmm's contract allows runs.  bk and bn, the reference's k and
// column tiling, do not change the result and are only checked by the
// wrapper; the block stages K through shared memory 32 deep and covers 64
// columns.
//
// What bounds it on the H100: at serving shapes (K, N) = (1024, 512) and
// (512, 1024) in bf16, each row tile reads its group's whole 1 MB slab for
// 2 * rows * K * N operations.  Decode has 1-2 real rows per tile, about 2
// operations a byte, far below the card's ~295 bf16 operations a byte: the
// weight bytes set the bound, and the kernel's job is to stream them at full
// rate.  So loads are coalesced along N (w) and K (x), and each k slice is
// loaded into registers while the previous one is multiplied out of shared
// memory, so one slice's global-memory latency overlaps the other's work.
// The products run on the CUDA cores in fp32 (bf16 inputs are widened when
// staged): no tensor cores, cp.async/TMA or wgmma yet.  At prefill (up to 16
// real rows per 16-row tile), fp32 FMA on the CUDA cores becomes the limit.
//
// Plain C interface, bound with ctypes: every pointer and the stream are
// void*; the entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TN = 64;         // output columns per CUDA block
constexpr int TK = 32;         // depth staged through shared memory per step
constexpr int THREADS = 256;   // 16 x 16 threads; RI rows x 4 columns each

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// T: input type (x and w), O: output type, RI: rows per thread (TM = 16 RI).
// Grid: x = (row tile, row sub-tile), y = column block.
template <typename T, typename O, int RI>
__global__ void __launch_bounds__(THREADS) gmm_kernel(
        const T* __restrict__ x, const T* __restrict__ w,
        const int* __restrict__ group_ids, int K, int N, int G, int bm,
        int subs, O* __restrict__ out) {
    constexpr int TM = 16 * RI;
    constexpr int A_PER = TM * TK / THREADS;   // x values staged per thread
    constexpr int B_PER = TK * TN / THREADS;   // w values staged per thread
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int tile = blockIdx.x / subs;
    const int m0 = (blockIdx.x % subs) * TM;   // sub-tile origin in the tile
    const int tm = min(TM, bm - m0);
    const int n0 = blockIdx.y * TN;
    const int tn = min(TN, N - n0);
    const size_t row0 = (size_t)tile * bm + m0;
    const int g = group_ids[tile];             // uniform across the block

    if (g < 0 || g >= G) {                     // idle tile: zeros
#pragma unroll
        for (int i = 0; i < RI; ++i) {
            const int r = ty + 16 * i;
            if (r >= tm) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j;
                if (c < tn) put(out + (row0 + r) * N + n0 + c, 0.0f);
            }
        }
        return;
    }

    __shared__ float As[TK][TM + 1];
    __shared__ float Bs[TK][TN];
    const T* __restrict__ xt = x + row0 * K;
    const T* __restrict__ wg = w + (size_t)g * K * N;
    float a_reg[A_PER], b_reg[B_PER];

    // global -> registers for the slice at depth k0 (zero past the edges)
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / TK, k = idx % TK;
            a_reg[i] = (r < tm && k0 + k < K)
                ? widen(xt[(size_t)r * K + k0 + k]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < B_PER; ++i) {
            const int idx = tid + i * THREADS;
            const int k = idx / TN, c = idx % TN;
            b_reg[i] = (c < tn && k0 + k < K)
                ? widen(wg[(size_t)(k0 + k) * N + n0 + c]) : 0.0f;
        }
    };

    float acc[RI][4] = {};
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int idx = tid + i * THREADS;
            As[idx % TK][idx / TK] = a_reg[i];
        }
#pragma unroll
        for (int i = 0; i < B_PER; ++i) {
            const int idx = tid + i * THREADS;
            Bs[idx / TN][idx % TN] = b_reg[i];
        }
        __syncthreads();
        if (k0 + TK < K) fetch(k0 + TK);       // in flight during the FMAs
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
            float av[RI], bv[4];
#pragma unroll
            for (int i = 0; i < RI; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        if (r >= tm) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            if (c < tn) put(out + (row0 + r) * N + n0 + c, acc[i][j]);
        }
    }
}

template <typename T, typename O>
int launch(const void* x, const void* w, const void* group_ids, int M, int K,
           int N, int G, int bm, void* out, cudaStream_t stream) {
    const int tiles = M / bm;
    const int cols = (N + TN - 1) / TN;
    if (bm <= 16) {
        const dim3 grid(tiles, cols);
        gmm_kernel<T, O, 1><<<grid, THREADS, 0, stream>>>(
            (const T*)x, (const T*)w, (const int*)group_ids, K, N, G, bm, 1,
            (O*)out);
    } else {
        const int subs = (bm + 63) / 64;
        const dim3 grid(tiles * subs, cols);
        gmm_kernel<T, O, 4><<<grid, THREADS, 0, stream>>>(
            (const T*)x, (const T*)w, (const int*)group_ids, K, N, G, bm,
            subs, (O*)out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  M % bm == 0; the wrapper checks
// every shape before the launch.
extern "C" int flexagon_gmm(const void* x, const void* w,
                            const void* group_ids, int M, int K, int N, int G,
                            int bm, int in_dtype, int out_dtype, void* out,
                            void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (in_dtype == 0 && out_dtype == 0)
        return launch<float, float>(x, w, group_ids, M, K, N, G, bm, out, s);
    if (in_dtype == 0 && out_dtype == 1)
        return launch<float, __nv_bfloat16>(x, w, group_ids, M, K, N, G, bm,
                                            out, s);
    if (in_dtype == 1 && out_dtype == 0)
        return launch<__nv_bfloat16, float>(x, w, group_ids, M, K, N, G, bm,
                                            out, s);
    if (in_dtype == 1 && out_dtype == 1)
        return launch<__nv_bfloat16, __nv_bfloat16>(x, w, group_ids, M, K, N,
                                                    G, bm, out, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* flexagon_gmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
