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
// x[t*bm:(t+1)*bm]^T @ dy[t*bm:(t+1)*bm], a (G, K, N) result summed in fp32
// and rounded once.  Idle tiles (id -1, or not below G) count for no group;
// a group with no tiles gives zeros; the host never learns the group sizes;
// no atomics, so the same inputs give the same bits on every launch.
// - what bounds it: at granite's training shapes (33,280 padded rows of
//   which 32,768 real, 32 groups, (K, N) = (1024, 512) and (512, 1024),
//   bf16) one call moves 64 MiB of x, 32 MiB of dy and 32 MiB of dw, 0.040
//   ms at 3.35 TB/s, and does 2 * 32768 * 1024 * 512 = 34 GFLOP, 0.035 ms
//   at 989 TFLOP/s: the bytes set the bound, the tensor cores are close
//   behind.  So a block must read its rows once per large dw tile, and keep
//   the tensor cores fed while it streams them.
// - wgrad_tma_kernel (bf16, where TMA can take the operands: K and N
//   multiples of 8, 16-byte-aligned bases, bm a multiple of 16, rows > 0).
//   One block owns a 128 x 256 piece of one group's dw; x = K block + N
//   block * (K blocks), y = group, so the blocks of a group are neighbours
//   in launch order and share its rows in L2: at (1024, 512) each row of x
//   is read by 2 blocks and each row of dy by 8, 0.40 GB through L2 a call
//   where 64 x 64 tiles read 1.07 GB.
//   - the group's tiles: the whole block reads the first 131,072 tile ids
//     at once into a bitmap in shared memory (a ballot per 32 ids); the
//     producer warp then walks it 32 words at a time, skips empty words,
//     takes each run of set bits whole and joins adjacent runs, so its
//     cost is per run, not per tile (a per-tile walk left the tensor cores
//     waiting on it).  Ids past the bitmap are balloted as it goes.
//   - loads: the producer streams each run in pieces of 64 rows, with TMA,
//     into a ring of 4 stages (x's 64 x 128 and dy's 64 x 256, 48 KB a
//     stage, 128-byte swizzle), each with a full and an empty mbarrier; a
//     stage carries its count of rows, and a count of 0 ends the walk, so
//     the ring never drains.
//   - products: two consumer warpgroups, 64 dw rows each, run wgmma
//     m64n256k16 with both operands read from shared memory as stored:
//     the row axis is the product's depth, A = x^T is M-major and B = dy
//     is N-major, which the instruction's transpose bits take for bf16, so
//     no transpose copy is made.  A piece of r rows is r / 16 wgmmas, so a
//     partial piece reads no row it did not list.  fp32 sums stay in
//     registers (128 a thread).
//   - epilogue: the tile goes through the idle ring in the 128-byte
//     swizzle and out by TMA stores, clipped at K and N (per-thread
//     stores from registers took a fifth of the kernel).
//   - no row split: at granite's training shapes the grid is 512 blocks,
//     about 4 per SM; the sweeps' small calls run fewer blocks, correctly.
//   x's, dy's and dw's tensor maps are encoded on the host at each call
//   (cuTensorMapEncodeTiled, from libcuda.so.1 by dlopen) and passed as
//   __grid_constant__ parameters.
// - wgrad_mma_kernel (bf16, every other shape: K = 260, misaligned bases):
//   one block per 64 x 64 piece of one group's dw, 4 warps of mma.sync
//   m16n8k16 over 16-row steps through a ring of cp.async stages; each
//   block lists its group's tiles 128 ids at a time with a ballot.  fp32
//   (wgrad_fma_kernel): the same walk, fused multiply-adds on the CUDA
//   cores.

// Plain C interface, bound with ctypes: every pointer and the stream are
// void*; the entry returns the first CUDA error of its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

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

// -- K3w on Hopper: TMA into an mbarrier ring, wgmma on both operands -------

constexpr int TW_BM = 128;            // dw rows (K) per block: 2 x 64
constexpr int TW_BN = 256;            // dw columns (N) per block
constexpr int TW_R = 64;              // rows of x and dy per stage
constexpr int TW_STAGES = 4;
constexpr int TW_CHUNK = 64;          // elements of one 128-byte row
constexpr int TW_CHUNK_BYTES = TW_R * TW_CHUNK * 2;    // one TMA box, 8 KB
constexpr int TW_XCH = TW_BM / TW_CHUNK;               // x boxes a stage
constexpr int TW_DCH = TW_BN / TW_CHUNK;               // dy boxes a stage
constexpr int TW_STAGE_BYTES = (TW_XCH + TW_DCH) * TW_CHUNK_BYTES;
constexpr int TW_CONSUMER_WARPS = 8;  // two warpgroups
constexpr int TW_THREADS = 32 * TW_CONSUMER_WARPS + 32;  // + the producer
// words of the block's bitmap of its group's tiles: the first 32 x this
// tile ids are scanned by the whole block at once, any after them by the
// producer as it goes
constexpr int TW_MAP_WORDS = 4096;
// the ring, 1 KB to align it for the swizzle, the barriers and row
// counts, the bitmap
constexpr int TW_SMEM = TW_STAGES * TW_STAGE_BYTES + 1024 + 128
    + TW_MAP_WORDS * 4;
static_assert(TW_SMEM <= 232448, "over the H100's 227 KB a block");
// an error of the TMA launch that is not CUDA's own: the tensor maps could
// not be encoded
constexpr int TW_ENCODE_FAILED = 100000;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}
// box (c0 = column, c1 = row) of the map's first plane -> dst, counted on
// bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(c0), "r"(c1), "r"(0), "r"(smem_addr(bar)) : "memory");
}

// shared -> box (c0 = column, c1 = row, c2 = plane) of the map
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
           "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// A shared-memory operand of wgmma in the 128-byte swizzle TMA writes:
// rows of 128 bytes, 8-row atoms of 1 KB.  For an MN-major operand, lbo is
// the byte distance between 64-element blocks along M (or N), sbo between
// 8-row groups along the depth.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
        | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
        | (uint64_t)1 << 62;
}
constexpr unsigned TW_LBO = TW_CHUNK_BYTES;  // next 64 columns: next box
constexpr unsigned TW_SBO = 8 * 128;         // next 8 rows: next atom

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// d (64 x 256, fp32) += A (64 x 16) @ B (16 x 256), both bf16 in shared
// memory, A M-major and B N-major (transpose bits 1, 1)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

// dw[g] for a 128 x 256 block of one group.
// Grid: x = K block + N block * (K blocks), y = group.  Warps 0-7 (two
// warpgroups) multiply, warp 8 loads.  tmo is dw (G, K, N) in O, in boxes
// of 128 rows x 128 bytes.
template <typename O>
__global__ void __launch_bounds__(TW_THREADS, 1) wgrad_tma_kernel(
        const __grid_constant__ CUtensorMap tmx,
        const __grid_constant__ CUtensorMap tmd,
        const __grid_constant__ CUtensorMap tmo,
        const int* __restrict__ group_ids, int tiles, int K, int N,
        int bm) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring
                                                 + TW_STAGES * TW_STAGE_BYTES);
    uint64_t* empty = full + TW_STAGES;
    int* stage_rows = reinterpret_cast<int*>(empty + TW_STAGES);
    unsigned* map = reinterpret_cast<unsigned*>(ring + TW_STAGES
                                                * TW_STAGE_BYTES + 128);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int kblocks = (K + TW_BM - 1) / TW_BM;
    const int g = blockIdx.y;
    const int k0 = (blockIdx.x % kblocks) * TW_BM;
    const int n0 = (blockIdx.x / kblocks) * TW_BN;

    if (tid == 0) {
        for (int s = 0; s < TW_STAGES; ++s) {
            mbar_init(&full[s], 1);      // the producer's arrival + bytes
            mbar_init(&empty[s], TW_CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // bit b of map[w]: tile 32 w + b is the group's.  Each warp reads 8
    // words' ids before its ballots, so the block waits on about one round
    // trip to L2 for the first 72 x 32 ids
    const int words = (tiles + 31) >> 5;
    const int mapped = min(words, TW_MAP_WORDS);
    constexpr int WARPS = TW_THREADS / 32;
    for (int w0 = warp; w0 < mapped; w0 += 8 * WARPS) {
        int id[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int t = (w0 + j * WARPS) * 32 + lane;
            id[j] = w0 + j * WARPS < mapped && t < tiles
                ? __ldg(group_ids + t) : -1;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const unsigned m = __ballot_sync(0xffffffffu, id[j] == g);
            if (lane == 0 && w0 + j * WARPS < mapped) map[w0 + j * WARPS] = m;
        }
    }
    __syncthreads();

    if (warp == TW_CONSUMER_WARPS) {
        // the producer: the group's tiles in id order, adjacent ones joined
        // into runs, each run in pieces of up to TW_R rows
        int nx = 0, nd = 0;
        for (int c = 0; c < TW_XCH; ++c) nx += k0 + c * TW_CHUNK < K;
        for (int c = 0; c < TW_DCH; ++c) nd += n0 + c * TW_CHUNK < N;
        const unsigned bytes = (nx + nd) * TW_CHUNK_BYTES;
        int stage = 0;
        unsigned phase = 0;
        auto emit = [&](int row, int rows) {
            mbar_wait(&empty[stage], phase ^ 1);
            if (lane == 0) {
                unsigned char* st = ring + stage * TW_STAGE_BYTES;
                stage_rows[stage] = rows;
                mbar_expect_tx(&full[stage], bytes);
                // boxes wholly past K or N are not loaded: only the rows or
                // columns of dw that the epilogue drops read them
                for (int c = 0; c < nx; ++c)
                    tma_load(st + c * TW_CHUNK_BYTES, &tmx,
                             k0 + c * TW_CHUNK, row, &full[stage]);
                for (int c = 0; c < nd; ++c)
                    tma_load(st + (TW_XCH + c) * TW_CHUNK_BYTES, &tmd,
                             n0 + c * TW_CHUNK, row, &full[stage]);
            }
            __syncwarp();
            if (++stage == TW_STAGES) {
                stage = 0;
                phase ^= 1;
            }
        };
        int run_row = 0, run_rows = 0;
        auto flush = [&]() {
            while (run_rows > 0) {
                const int r = min(TW_R, run_rows);
                emit(run_row, r);
                run_row += r;
                run_rows -= r;
            }
        };
        // 32 words at a time, lane l holding word w0 + l: the words in the
        // bitmap are read at once, the ones past it (mapped is then a
        // multiple of 32) ballot their ids; only non-empty words are walked
        for (int w0 = 0; w0 < words; w0 += 32) {
            unsigned word = 0;
            if (w0 < mapped) {
                if (w0 + lane < mapped) word = map[w0 + lane];
            } else {
                for (int l = 0; l < 32 && w0 + l < words; ++l) {
                    const int t = (w0 + l) * 32 + lane;
                    const unsigned b = __ballot_sync(
                        0xffffffffu, t < tiles && __ldg(group_ids + t) == g);
                    if (lane == l) word = b;
                }
            }
            unsigned busy = __ballot_sync(0xffffffffu, word != 0);
            while (busy) {
                const int l = __ffs(busy) - 1;
                busy &= busy - 1;
                const int w = w0 + l;
                unsigned m = __shfl_sync(0xffffffffu, word, l);
                while (m) {                  // each run of set bits at once
                    const int lo = __ffs(m) - 1;
                    const unsigned rest = ~(m >> lo);
                    const int len = rest ? __ffs(rest) - 1 : 32 - lo;
                    m &= ~(unsigned)(((1ull << len) - 1) << lo);
                    const int row = (w * 32 + lo) * bm;
                    if (run_rows > 0 && row == run_row + run_rows) {
                        run_rows += len * bm;
                    } else {
                        flush();
                        run_row = row;
                        run_rows = len * bm;
                    }
                    while (run_rows >= TW_R) {
                        emit(run_row, TW_R);
                        run_row += TW_R;
                        run_rows -= TW_R;
                    }
                }
            }
        }
        flush();
        mbar_wait(&empty[stage], phase ^ 1);     // a count of 0 ends it
        if (lane == 0) {
            stage_rows[stage] = 0;
            mbar_arrive(&full[stage]);
        }
        return;
    }

    // the consumers: warpgroup wg owns dw rows k0 + 64 wg ... + 63
    const int wg = warp >> 2;
    const bool live = k0 + wg * TW_CHUNK < K;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0, held = -1;
    unsigned phase = 0;
    while (true) {
        mbar_wait(&full[stage], phase);
        __syncwarp();       // the lanes leave the wait together for wgmma
        const int rows = stage_rows[stage];
        if (rows == 0) break;
        if (live) {
            const unsigned st = smem_addr(ring + stage * TW_STAGE_BYTES);
            const unsigned a0 = st + wg * TW_CHUNK_BYTES;
            const unsigned b0 = st + TW_XCH * TW_CHUNK_BYTES;
            fence_acc(d);
            wgmma_fence();
            for (int j = 0; j < rows / 16; ++j)      // 16 rows: 2 KB
                wgmma_m64n256k16(d, sw128_desc(a0 + j * 2048, TW_LBO, TW_SBO),
                                 sw128_desc(b0 + j * 2048, TW_LBO, TW_SBO));
            wgmma_commit();
            fence_acc(d);
        }
        // the products of the stage before have read it: release that one,
        // once every lane of the warp is past its read of stage_rows
        wgmma_wait<1>();
        fence_acc(d);
        __syncwarp();
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == TW_STAGES) {
            stage = 0;
            phase ^= 1;
        }
    }
    wgmma_wait<0>();
    fence_acc(d);

    // the epilogue: the tile goes through the ring, now idle, into boxes of
    // 128 rows x 128 bytes in the 128-byte swizzle (row r's 16-byte chunk c
    // at r * 128 + (c ^ r % 8) * 16, so a warp's 8 rows hit 8 chunks), then
    // to dw by TMA.  d[4 i + 2 h + e] is the tile's row 64 wg + 16 (warp % 4)
    // + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + e.  Both warpgroups are
    // past their last product before either writes.
    asm volatile("bar.sync 1, %0;\n" :: "n"(32 * TW_CONSUMER_WARPS));
    constexpr bool fp32 = sizeof(O) == 4;
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row + 8 * h, c = 8 * i + 2 * (lane & 3);
            const float a = d[4 * i + 2 * h], b = d[4 * i + 2 * h + 1];
            if (fp32) {         // boxes of 32 columns
                const int cc = c & 31;
                *reinterpret_cast<float2*>(
                    ring + (c >> 5) * TW_R * 256 + r * 128
                    + (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4) =
                    make_float2(a, b);
            } else {            // boxes of 64 columns
                const int cc = c & 63;
                *reinterpret_cast<__nv_bfloat162*>(
                    ring + (c >> 6) * TW_R * 256 + r * 128
                    + (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2) =
                    __floats2bfloat162_rn(a, b);
            }
        }
    }
    // the writes, made by the threads, are read by TMA's proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(32 * TW_CONSUMER_WARPS));
    if (tid == 0) {
        constexpr int width = fp32 ? 32 : 64;
        for (int b = 0; b * width < TW_BN && n0 + b * width < N; ++b)
            tma_store(&tmo, ring + b * TW_R * 256, n0 + b * width, k0, g);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
}

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded;
// null where it is missing
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
        return lib ? reinterpret_cast<EncodeTiled>(
                         dlsym(lib, "cuTensorMapEncodeTiled"))
                   : nullptr;
    }();
    return fn;
}

// a row-major tensor of planes x rows x cols of the given type, in boxes
// of box_rows x 128 bytes with the 128-byte swizzle; zeros past its edges
// when read, nothing written past them
bool encode(CUtensorMap* map, CUtensorMapDataType type, int esize,
            const void* base, int planes, int rows, int cols, int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                                (cuuint64_t)planes};
    const cuuint64_t strides[2] = {(cuuint64_t)cols * esize,
                                   (cuuint64_t)rows * cols * esize};
    const cuuint32_t box[3] = {(cuuint32_t)(128 / esize),
                               (cuuint32_t)box_rows, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    return fn(map, type, 3, const_cast<void*>(base), dims, strides, box,
              step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename O>
int launch_wgrad_tma(const void* x, const void* dy, const void* group_ids,
                     int M, int K, int N, int G, int bm, void* dw,
                     cudaStream_t stream) {
    constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    constexpr bool out32 = sizeof(O) == 4;
    CUtensorMap tmx, tmd, tmo;
    if (!encode(&tmx, BF16, 2, x, 1, M, K, TW_R)
            || !encode(&tmd, BF16, 2, dy, 1, M, N, TW_R)
            || !encode(&tmo, out32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : BF16,
                       sizeof(O), dw, G, K, N, TW_BM))
        return TW_ENCODE_FAILED;
    auto kernel = wgrad_tma_kernel<O>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TW_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(((K + TW_BM - 1) / TW_BM) * ((N + TW_BN - 1) / TW_BN), G);
    kernel<<<grid, TW_THREADS, TW_SMEM, stream>>>(
        tmx, tmd, tmo, (const int*)group_ids, M / bm, K, N, bm);
    return (int)cudaGetLastError();
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
// (0 = float32, 1 = bfloat16), M % bm == 0, G <= 65535.  variant comes
// from the wrapper's plan (wgrad_plan): 0 = the general kernels
// (wgrad_mma_kernel for bf16, wgrad_fma_kernel for fp32), 1 =
// wgrad_tma_kernel, which takes bf16 with K % 8 == N % 8 == 0, 16-byte
// aligned x and dy, bm % 16 == 0 and M > 0.  A variant refused for these
// operands returns an error; the wrapper checks every shape before the
// launch.
extern "C" int flexagon_gmm_wgrad(const void* x, const void* dy,
                                  const void* group_ids, int M, int K, int N,
                                  int G, int bm, int in_dtype, int out_dtype,
                                  int variant, void* dw, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (bm < 1 || G < 1 || K < 1 || N < 1 || (in_dtype != 0 && in_dtype != 1)
            || (out_dtype != 0 && out_dtype != 1))
        return (int)cudaErrorInvalidValue;
    if (variant == 1) {
        if (in_dtype != 1 || K % 8 || N % 8 || bm % 16 || M < 1
                || (uintptr_t)x % 16 || (uintptr_t)dy % 16)
            return (int)cudaErrorInvalidValue;
        if (out_dtype == 0)
            return launch_wgrad_tma<float>(x, dy, group_ids, M, K, N, G, bm,
                                           dw, s);
        return launch_wgrad_tma<__nv_bfloat16>(x, dy, group_ids, M, K, N, G,
                                               bm, dw, s);
    }
    if (variant != 0) return (int)cudaErrorInvalidValue;
    if (out_dtype == 0)
        return launch_wgrad<float>(x, dy, group_ids, M, K, N, G, bm,
                                   in_dtype, dw, s);
    return launch_wgrad<__nv_bfloat16>(x, dy, group_ids, M, K, N, G, bm,
                                       in_dtype, dw, s);
}

extern "C" const char* flexagon_gmm_error_string(int code) {
    if (code == TW_ENCODE_FAILED)
        return "cannot encode K3w's tensor maps (cuTensorMapEncodeTiled "
               "from libcuda.so.1)";
    return cudaGetErrorString((cudaError_t)code);
}
