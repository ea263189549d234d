// The port's grouped matmul for Mixture-of-Experts expert compute, for
// Hopper (sm_90a).
//
// K3 replaces the Pallas kernel
//    src/repro/kernels/moe_gmm.py:31 _kernel (pallas_call at :68),
// launched there by gmm (:41).
//
// It computes out[t*bm:(t+1)*bm] = x[t*bm:(t+1)*bm] @ w[group_ids[t]]: rows
// are sorted by group and padded per group to the row tile bm, so every row
// tile multiplies one group's (K, N) weight slab.  The TPU kernel's grid is
// (row tile, column tile, k tile) with the k axis sequential, carrying an
// fp32 accumulator in VMEM from one k step to the next.  Here one CUDA block
// owns one output tile of (16 or 64 rows of one row tile) x (64 columns)
// and loops over its share of K itself, in order, summing in fp32.
//
// Row tiles whose group id is negative (or not below G) are idle: the
// device form of pad_groups gives the tiles past the real count that marker,
// since it sizes the row space by a static bound and never asks the host for
// the real count.  An idle tile reads nothing and writes zeros.
//
// What bounds it on the H100: at serving shapes (K, N) = (1024, 512) and
// (512, 1024) in bf16, each row tile reads its group's whole 1 MiB slab for
// 2 * rows * K * N operations.  Decode has 1-2 real rows per 16-row tile,
// about 2 operations a byte, far below the card's ~295 bf16 operations a
// byte: the weight bytes set the bound, and the kernel's job is to keep
// enough of them in flight to stream at the memory's rate.  Prefill has up
// to 16 real rows a tile and re-reads each slab once per tile, mostly from
// L2.
//
// gmm_mma_kernel (bf16 inputs, the serving path):
// - products on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> fp32,
//   operands loaded from shared memory with ldmatrix (x as is, w with .trans
//   since it is (K, N) row-major).  m16 is the sort path's 16-row tile; a
//   64-row block is four m16 fragments of one group.  wgmma, which needs
//   64-row warpgroup tiles, would waste 75% of its work at decode.
// - loads: a ring of STAGES slices, each 64 deep (x rows and the w slab's
//   64 x 64 piece), streamed with 16-byte cp.async.cg copies and waited on
//   with cp.async.wait_group, so STAGES - 1 slices are in flight while one
//   is multiplied: 40 KB of weights per 16-row block.  Rows are padded by
//   16 bytes so ldmatrix reads without bank conflicts.  Shapes whose rows are
//   not 16-byte aligned (K or N not a multiple of 8) load element by element
//   instead, through the same ring.
// - grid: (row tile x sub-tile, 64-column block, K split).  A decode call
//   (34 tiles of which ~21 real, N = 512) gives 272 blocks with no split;
//   where tiles x column blocks fall below ~2 blocks per SM the host splits
//   K, each split writes an fp32 partial plane, and gmm_reduce_kernel sums
//   the planes in split order and rounds once.  No atomics: the same inputs
//   give the same bits on every launch.
// The result is rounded to the output type once, in the epilogue.
//
// gmm_fma_kernel (fp32 inputs, which only the sweeps use): the products run
// on the CUDA cores with fused multiply-adds, since TF32 would not keep fp32
// parity.  It stages K through shared memory 32 deep, prefetching the next
// slice into registers while the current one is multiplied.
//
// K3w, the weight gradient of K3 (flexagon_gmm_wgrad), has no TPU kernel
// to replace: the JAX package trains through jax.lax.ragged_dot
// (src/repro/models/moe.py:178-181) and XLA differentiates it.  It computes
// dw[g] = sum over the row tiles t with group_ids[t] == g of
// x[t*bm:(t+1)*bm]^T @ dy[t*bm:(t+1)*bm], a (G, K, N) result summed in fp32.
// - grid: one block per (64 K rows, 64 N columns) of one group's dw slab,
//   x = K block + N block, y = group; blocks of one group are neighbours in
//   launch order, so the rows they share are read from L2.
// - each block finds its group's tiles itself, on the device: it reads the
//   group ids THREADS at a time, and a warp ballot and popcounts list the
//   matching tiles in order; the host never learns the group sizes.  Idle
//   tiles (id -1, or not below G) match no group and are skipped.
// - it walks those tiles in order, 16 rows at a time, summing in registers:
//   no atomics and no second pass, so the same inputs give the same bits.
//   A group with no tiles writes zeros.
// - bf16 (wgrad_mma_kernel): mma.sync m16n8k16 with the row axis as the
//   product's depth.  x's slice is stored (rows, K) and read as A = x^T with
//   ldmatrix .trans; dy's slice (rows, N) as B with .trans, as K3 reads w.
//   Slices stream through a ring of cp.async stages.  fp32
//   (wgrad_fma_kernel): fused multiply-adds on the CUDA cores.
// - what bounds it: at granite's training shapes (32768 routed rows,
//   (K, N) = (1024, 512)) one call is 2 * 32768 * 1024 * 512 = 34 GFLOP on
//   64 MiB of x and 32 MiB of dy, about 360 operations a byte: the tensor
//   cores set the bound.  This first version is simple (4 warps, 16-row
//   steps, a sync per step), not fast.
//
// Plain C interface, bound with ctypes: every pointer and the stream are
// void*; the entry returns the first CUDA error of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// -- bf16 on the tensor cores ------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps
constexpr int BN = 64;             // output columns per block
constexpr int BK = 64;             // depth of one pipeline slice
constexpr int LDS = BK + 8;        // x slice row stride, elements (+16 B)
constexpr int LDW = BN + 8;        // w slice row stride, elements (+16 B)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !ok (nothing is read then;
// callers still pass an address inside the operand)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}
// d += a (16x16, row) @ b (16x8, col), bf16 in, fp32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MF, int STAGES>
constexpr int mma_smem_bytes() {
    return STAGES * (16 * MF * LDS + BK * LDW) * 2;
}

// MF: m16 fragments per block (block rows TM = 16 MF).  Warps: 1 x 4 for
// MF = 1 (each warp 16 columns), 2 x 2 for MF = 4 (each 32 x 32).
// Grid: x = (row tile, row sub-tile), y = column block, z = K split.
// part == nullptr: write out, rounded; else write this split's fp32 plane.
template <typename O, int MF, int STAGES>
__global__ void __launch_bounds__(MMA_THREADS) gmm_mma_kernel(
        const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ w,
        const int* __restrict__ group_ids, int M, int K, int N, int G, int bm,
        int subs, int k_len, int vec, O* __restrict__ out,
        float* __restrict__ part) {
    constexpr int TM = 16 * MF;
    constexpr int WARPS_M = MF == 1 ? 1 : 2;
    constexpr int WARPS_N = 4 / WARPS_M;
    constexpr int MFW = MF / WARPS_M;             // m16 fragments per warp
    constexpr int NFW = BN / 8 / WARPS_N;         // n8 fragments per warp
    static_assert(NFW % 2 == 0, "B fragments load in pairs");
    constexpr int X_STAGE = TM * LDS, W_STAGE = BK * LDW;

    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* wsm = xs + STAGES * X_STAGE;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int tile = blockIdx.x / subs;
    const int m0 = (blockIdx.x % subs) * TM;      // sub-tile origin in tile
    const int tm = min(TM, bm - m0);
    const int n0 = blockIdx.y * BN;
    const int tn = min(BN, N - n0);
    const size_t row0 = (size_t)tile * bm + m0;
    const int kb = blockIdx.z * k_len;
    const int ke = min(K, kb + k_len);
    const int g = group_ids[tile];                // uniform across the block
    float* plane = part ? part + (size_t)blockIdx.z * M * N : nullptr;

    auto emit = [&](int r, int c, float v) {
        const size_t at = (row0 + r) * N + n0 + c;
        if (plane) plane[at] = v;
        else put(out + at, v);
    };

    if (g < 0 || g >= G) {                        // idle tile: zeros
        for (int i = tid; i < TM * BN; i += MMA_THREADS) {
            const int r = i / BN, c = i % BN;
            if (r < tm && c < tn) emit(r, c, 0.0f);
        }
        return;
    }

    const __nv_bfloat16* __restrict__ xt = x + row0 * K;
    const __nv_bfloat16* __restrict__ wg = w + (size_t)g * K * N;

    // slice at depth k0 -> ring slot s; zeros past the tile and the split
    auto load = [&](int s, int k0) {
        __nv_bfloat16* xd = xs + s * X_STAGE;
        __nv_bfloat16* wd = wsm + s * W_STAGE;
#pragma unroll
        for (int i = 0; i < TM * BK / 8 / MMA_THREADS; ++i) {
            const int q = tid + i * MMA_THREADS;
            const int r = q / (BK / 8), k = (q % (BK / 8)) * 8;
            const bool row_ok = r < tm;
            if (vec) {
                const bool ok = row_ok && k0 + k < ke;
                cp_async16(xd + r * LDS + k,
                           ok ? xt + (size_t)r * K + k0 + k : xt, ok);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    xd[r * LDS + k + e] = (row_ok && k0 + k + e < ke)
                        ? xt[(size_t)r * K + k0 + k + e]
                        : __float2bfloat16(0.0f);
            }
        }
#pragma unroll
        for (int i = 0; i < BK * BN / 8 / MMA_THREADS; ++i) {
            const int q = tid + i * MMA_THREADS;
            const int k = q / (BN / 8), c = (q % (BN / 8)) * 8;
            const bool k_ok = k0 + k < ke;
            if (vec) {
                const bool ok = k_ok && c < tn;
                cp_async16(wd + k * LDW + c,
                           ok ? wg + (size_t)(k0 + k) * N + n0 + c : wg, ok);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    wd[k * LDW + c + e] = (k_ok && c + e < tn)
                        ? wg[(size_t)(k0 + k) * N + n0 + c + e]
                        : __float2bfloat16(0.0f);
            }
        }
    };

    float acc[MFW][NFW][4] = {};
    const int nk = (ke - kb + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load(s, kb + s * BK);
        cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
        cp_async_wait<STAGES - 2>();              // slice t has landed
        __syncthreads();                          // ... and slot t-1 is free
        const int next = t + STAGES - 1;
        if (next < nk) load(next % STAGES, kb + next * BK);
        cp_async_commit();

        const __nv_bfloat16* xd = xs + (t % STAGES) * X_STAGE;
        const __nv_bfloat16* wd = wsm + (t % STAGES) * W_STAGE;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            unsigned a[MFW][4];
#pragma unroll
            for (int mi = 0; mi < MFW; ++mi) {
                const int r = (wm * MFW + mi) * 16 + (lane & 15);
                ldsm_x4(a[mi], xd + r * LDS + kk + (lane >> 4) * 8);
            }
#pragma unroll
            for (int nj = 0; nj < NFW / 2; ++nj) {
                unsigned b[4];
                const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
                const int c = (wn * NFW + 2 * nj) * 8 + (lane >> 4) * 8;
                ldsm_x4_trans(b, wd + k * LDW + c);
#pragma unroll
                for (int mi = 0; mi < MFW; ++mi) {
                    mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
                    mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mi = 0; mi < MFW; ++mi) {
#pragma unroll
        for (int ni = 0; ni < NFW; ++ni) {
            const int r = (wm * MFW + mi) * 16 + (lane >> 2);
            const int c = (wn * NFW + ni) * 8 + (lane & 3) * 2;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
                const int rr = r + (h >> 1) * 8, cc = c + (h & 1);
                if (rr < tm && cc < tn) emit(rr, cc, acc[mi][ni][h]);
            }
        }
    }
}

// out = the K-split partial planes summed in split order, rounded once
template <typename O>
__global__ void gmm_reduce_kernel(const float* __restrict__ part, int splits,
                                  size_t mn, O* __restrict__ out) {
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
         i += stride) {
        float s = part[i];
        for (int z = 1; z < splits; ++z) s += part[(size_t)z * mn + i];
        put(out + i, s);
    }
}

// -- fp32 on the CUDA cores --------------------------------------------------

constexpr int TN = 64;         // output columns per CUDA block
constexpr int TK = 32;         // depth staged through shared memory per step
constexpr int THREADS = 256;   // 16 x 16 threads; RI rows x 4 columns each

// O: output type, RI: rows per thread (TM = 16 RI).
// Grid: x = (row tile, row sub-tile), y = column block.
template <typename O, int RI>
__global__ void __launch_bounds__(THREADS) gmm_fma_kernel(
        const float* __restrict__ x, const float* __restrict__ w,
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
    const float* __restrict__ xt = x + row0 * K;
    const float* __restrict__ wg = w + (size_t)g * K * N;
    float a_reg[A_PER], b_reg[B_PER];

    // global -> registers for the slice at depth k0 (zero past the edges)
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / TK, k = idx % TK;
            a_reg[i] = (r < tm && k0 + k < K) ? xt[(size_t)r * K + k0 + k]
                                              : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < B_PER; ++i) {
            const int idx = tid + i * THREADS;
            const int k = idx / TN, c = idx % TN;
            b_reg[i] = (c < tn && k0 + k < K)
                ? wg[(size_t)(k0 + k) * N + n0 + c] : 0.0f;
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

// -- K3w: the weight gradient ------------------------------------------------

constexpr int WG_BK = 64;            // dw rows (K) per block
constexpr int WG_BN = 64;            // dw columns (N) per block
constexpr int WG_R = 16;             // rows of x and dy per step
constexpr int WG_MMA_THREADS = 128;  // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int WG_FMA_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int WG_STAGES = 4;
constexpr int WG_LDX = WG_BK + 8;    // x slice row stride, elements (+16 B)
constexpr int WG_LDD = WG_BN + 8;    // dy slice row stride, elements (+16 B)

// The tiles of group g among tiles [base, base + blockDim.x), in order,
// into list; returns their count.  One tile per thread: a warp ballot, and
// popcounts of the warps before, give each match its place.
__device__ __forceinline__ int match_tiles(const int* __restrict__ group_ids,
                                           int tiles, int base, int g,
                                           int* list, unsigned* masks) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int t = base + tid;
    const bool hit = t < tiles && group_ids[t] == g;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) masks[warp] = m;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        const int c = __popc(masks[w]);
        if (w < warp) before += c;
        total += c;
    }
    if (hit) list[before + __popc(m & ((1u << lane) - 1u))] = t;
    __syncthreads();
    return total;
}

// Grid: x = K block + N block * (K blocks), y = group.
template <typename O>
__global__ void __launch_bounds__(WG_MMA_THREADS) wgrad_mma_kernel(
        const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ dy,
        const int* __restrict__ group_ids, int M, int K, int N, int bm,
        int vec, O* __restrict__ dw) {
    __shared__ __align__(16) __nv_bfloat16 xs[WG_STAGES][WG_R * WG_LDX];
    __shared__ __align__(16) __nv_bfloat16 ds[WG_STAGES][WG_R * WG_LDD];
    __shared__ int list[WG_MMA_THREADS];
    __shared__ unsigned masks[WG_MMA_THREADS / 32];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / 2, wn = warp % 2;       // 32 K rows x 32 N cols
    const int kblocks = (K + WG_BK - 1) / WG_BK;
    const int g = blockIdx.y;
    const int k0 = (blockIdx.x % kblocks) * WG_BK;
    const int n0 = (blockIdx.x / kblocks) * WG_BN;
    const int tk = min(WG_BK, K - k0), tn = min(WG_BN, N - n0);
    const int tiles = M / bm;
    const int subs = (bm + WG_R - 1) / WG_R;      // steps per tile

    // step `item` of the listed tiles -> ring slot s; zeros past the tile's
    // rows and the block's columns
    auto load = [&](int s, int item) {
        const int r0 = (item % subs) * WG_R;
        const int rows = min(WG_R, bm - r0);
        const size_t row0 = (size_t)list[item / subs] * bm + r0;
        const int r = tid / 8, c = (tid % 8) * 8;  // one 16-byte piece each
        const bool row_ok = r < rows;
        __nv_bfloat16* xd = xs[s] + r * WG_LDX + c;
        __nv_bfloat16* dd = ds[s] + r * WG_LDD + c;
        if (vec) {
            const bool okx = row_ok && c < tk, okd = row_ok && c < tn;
            cp_async16(xd, okx ? x + (row0 + r) * K + k0 + c : x, okx);
            cp_async16(dd, okd ? dy + (row0 + r) * N + n0 + c : dy, okd);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                xd[e] = (row_ok && c + e < tk)
                    ? x[(row0 + r) * K + k0 + c + e] : __float2bfloat16(0.0f);
                dd[e] = (row_ok && c + e < tn)
                    ? dy[(row0 + r) * N + n0 + c + e] : __float2bfloat16(0.0f);
            }
        }
    };

    float acc[2][4][4] = {};
    for (int base = 0; base < tiles; base += WG_MMA_THREADS) {
        const int items = match_tiles(group_ids, tiles, base, g, list,
                                      masks) * subs;
#pragma unroll
        for (int s = 0; s < WG_STAGES - 1; ++s) {
            if (s < items) load(s, s);
            cp_async_commit();
        }
        for (int it = 0; it < items; ++it) {
            cp_async_wait<WG_STAGES - 2>();       // step it has landed
            __syncthreads();                      // ... and slot it-1 is free
            const int next = it + WG_STAGES - 1;
            if (next < items) load(next % WG_STAGES, next);
            cp_async_commit();

            const __nv_bfloat16* xd = xs[it % WG_STAGES];
            const __nv_bfloat16* dd = ds[it % WG_STAGES];
            // A = x^T (K x rows): the stored (rows, K) slice, transposed
            unsigned a[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int r = (lane & 7) + ((lane >> 4) & 1) * 8;
                const int c = (wm * 2 + mi) * 16 + ((lane >> 3) & 1) * 8;
                ldsm_x4_trans(a[mi], xd + r * WG_LDX + c);
            }
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
                unsigned b[4];
                const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
                const int c = (wn * 4 + 2 * nj) * 8 + (lane >> 4) * 8;
                ldsm_x4_trans(b, dd + r * WG_LDD + c);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
                    mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
                }
            }
        }
        cp_async_wait<0>();
        __syncthreads();                          // the list is read
    }

    O* __restrict__ out = dw + (size_t)g * K * N;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int r = (wm * 2 + mi) * 16 + (lane >> 2);
            const int c = (wn * 4 + ni) * 8 + (lane & 3) * 2;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
                const int rr = r + (h >> 1) * 8, cc = c + (h & 1);
                if (rr < tk && cc < tn)
                    put(out + (size_t)(k0 + rr) * N + n0 + cc,
                        acc[mi][ni][h]);
            }
        }
    }
}

// fp32 inputs: the same walk, products on the CUDA cores.  Each thread owns
// dw rows ty + 16 i and columns tx + 16 j of the block's 64 x 64 tile.
template <typename O>
__global__ void __launch_bounds__(WG_FMA_THREADS) wgrad_fma_kernel(
        const float* __restrict__ x, const float* __restrict__ dy,
        const int* __restrict__ group_ids, int M, int K, int N, int bm,
        O* __restrict__ dw) {
    __shared__ float xs[WG_R][WG_BK];
    __shared__ float ds[WG_R][WG_BN];
    __shared__ int list[WG_FMA_THREADS];
    __shared__ unsigned masks[WG_FMA_THREADS / 32];

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int kblocks = (K + WG_BK - 1) / WG_BK;
    const int g = blockIdx.y;
    const int k0 = (blockIdx.x % kblocks) * WG_BK;
    const int n0 = (blockIdx.x / kblocks) * WG_BN;
    const int tk = min(WG_BK, K - k0), tn = min(WG_BN, N - n0);
    const int tiles = M / bm;
    const int subs = (bm + WG_R - 1) / WG_R;

    float acc[4][4] = {};
    for (int base = 0; base < tiles; base += WG_FMA_THREADS) {
        const int items = match_tiles(group_ids, tiles, base, g, list,
                                      masks) * subs;
        for (int it = 0; it < items; ++it) {
            const int r0 = (it % subs) * WG_R;
            const int rows = min(WG_R, bm - r0);
            const size_t row0 = (size_t)list[it / subs] * bm + r0;
#pragma unroll
            for (int i = 0; i < WG_R * WG_BK / WG_FMA_THREADS; ++i) {
                const int q = tid + i * WG_FMA_THREADS;
                const int r = q / WG_BK, c = q % WG_BK;
                xs[r][c] = (r < rows && c < tk)
                    ? x[(row0 + r) * K + k0 + c] : 0.0f;
                ds[r][c] = (r < rows && c < tn)
                    ? dy[(row0 + r) * N + n0 + c] : 0.0f;
            }
            __syncthreads();
#pragma unroll
            for (int r = 0; r < WG_R; ++r) {
                float av[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) av[i] = xs[r][ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = ds[r][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
            __syncthreads();
        }
    }

    O* __restrict__ out = dw + (size_t)g * K * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= tk) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            if (c < tn) put(out + (size_t)(k0 + r) * N + n0 + c, acc[i][j]);
        }
    }
}

template <typename O>
int launch_wgrad(const void* x, const void* dy, const void* group_ids, int M,
                 int K, int N, int G, int bm, int in_dtype, void* dw,
                 cudaStream_t stream) {
    const dim3 grid(((K + WG_BK - 1) / WG_BK) * ((N + WG_BN - 1) / WG_BN), G);
    if (in_dtype == 1) {
        const int vec = K % 8 == 0 && N % 8 == 0 && (uintptr_t)x % 16 == 0
            && (uintptr_t)dy % 16 == 0;
        wgrad_mma_kernel<O><<<grid, WG_MMA_THREADS, 0, stream>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy,
            (const int*)group_ids, M, K, N, bm, vec, (O*)dw);
    } else {
        wgrad_fma_kernel<O><<<grid, WG_FMA_THREADS, 0, stream>>>(
            (const float*)x, (const float*)dy, (const int*)group_ids, M, K,
            N, bm, (O*)dw);
    }
    return (int)cudaGetLastError();
}

// -- launches ----------------------------------------------------------------

template <typename O, int MF, int STAGES>
int launch_mma(const void* x, const void* w, const void* group_ids, int M,
               int K, int N, int G, int bm, int splits, int k_len, void* part,
               void* out, cudaStream_t stream) {
    constexpr int smem = mma_smem_bytes<MF, STAGES>();
    auto kernel = gmm_mma_kernel<O, MF, STAGES>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int subs = (bm + 16 * MF - 1) / (16 * MF);
    const dim3 grid((M / bm) * subs, (N + BN - 1) / BN, splits);
    // 16-byte copies need 16-byte aligned rows of x and w
    const int vec = K % 8 == 0 && N % 8 == 0 && (uintptr_t)x % 16 == 0
        && (uintptr_t)w % 16 == 0;
    float* plane = splits > 1 ? (float*)part : nullptr;
    kernel<<<grid, MMA_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (const int*)group_ids, M, K, N, G, bm, subs, k_len, vec, (O*)out,
        plane);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256
                                                      : 4096);
    gmm_reduce_kernel<O><<<blocks, 256, 0, stream>>>(plane, splits, mn,
                                                     (O*)out);
    return (int)cudaGetLastError();
}

template <typename O>
int launch_fma(const void* x, const void* w, const void* group_ids, int M,
               int K, int N, int G, int bm, int rows, void* out,
               cudaStream_t stream) {
    const int tiles = M / bm;
    const int cols = (N + TN - 1) / TN;
    if (rows == 16) {
        const dim3 grid(tiles, cols);
        gmm_fma_kernel<O, 1><<<grid, THREADS, 0, stream>>>(
            (const float*)x, (const float*)w, (const int*)group_ids, K, N, G,
            bm, 1, (O*)out);
    } else {
        const int subs = (bm + 63) / 64;
        const dim3 grid(tiles * subs, cols);
        gmm_fma_kernel<O, 4><<<grid, THREADS, 0, stream>>>(
            (const float*)x, (const float*)w, (const int*)group_ids, K, N, G,
            bm, subs, (O*)out);
    }
    return (int)cudaGetLastError();
}

template <typename O>
int launch_bf16(const void* x, const void* w, const void* group_ids, int M,
                int K, int N, int G, int bm, int rows, int splits, int k_len,
                void* part, void* out, cudaStream_t s) {
    if (rows == 16)
        return launch_mma<O, 1, 6>(x, w, group_ids, M, K, N, G, bm, splits,
                                   k_len, part, out, s);
    return launch_mma<O, 4, 4>(x, w, group_ids, M, K, N, G, bm, splits, k_len,
                               part, out, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  rows (16 or 64), splits and
// k_len come from the wrapper's launch plan: the block's row extent, the
// number of K splits and the depth of each; part holds splits planes of
// (M, N) fp32 when splits > 1.  fp32 inputs take no split.  M % bm == 0;
// the wrapper checks every shape before the launch.
extern "C" int flexagon_gmm(const void* x, const void* w,
                            const void* group_ids, int M, int K, int N, int G,
                            int bm, int in_dtype, int out_dtype, int rows,
                            int splits, int k_len, void* part, void* out,
                            void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if ((rows != 16 && rows != 64) || splits < 1 || k_len < 1
            || (splits > 1 && (part == nullptr || in_dtype != 1)))
        return (int)cudaErrorInvalidValue;
    if (in_dtype == 0 && out_dtype == 0)
        return launch_fma<float>(x, w, group_ids, M, K, N, G, bm, rows, out,
                                 s);
    if (in_dtype == 0 && out_dtype == 1)
        return launch_fma<__nv_bfloat16>(x, w, group_ids, M, K, N, G, bm,
                                         rows, out, s);
    if (in_dtype == 1 && out_dtype == 0)
        return launch_bf16<float>(x, w, group_ids, M, K, N, G, bm, rows,
                                  splits, k_len, part, out, s);
    if (in_dtype == 1 && out_dtype == 1)
        return launch_bf16<__nv_bfloat16>(x, w, group_ids, M, K, N, G, bm,
                                          rows, splits, k_len, part, out, s);
    return (int)cudaErrorInvalidValue;
}

// K3w: dw (G, K, N) in out_dtype from x (M, K) and dy (M, N) in in_dtype
// (0 = float32, 1 = bfloat16), M % bm == 0, G <= 65535; the wrapper checks
// every shape before the launch.
extern "C" int flexagon_gmm_wgrad(const void* x, const void* dy,
                                  const void* group_ids, int M, int K, int N,
                                  int G, int bm, int in_dtype, int out_dtype,
                                  void* dw, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (bm < 1 || G < 1 || K < 1 || N < 1 || (in_dtype != 0 && in_dtype != 1))
        return (int)cudaErrorInvalidValue;
    if (out_dtype == 0)
        return launch_wgrad<float>(x, dy, group_ids, M, K, N, G, bm,
                                   in_dtype, dw, s);
    if (out_dtype == 1)
        return launch_wgrad<__nv_bfloat16>(x, dy, group_ids, M, K, N, G, bm,
                                           in_dtype, dw, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* flexagon_gmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
