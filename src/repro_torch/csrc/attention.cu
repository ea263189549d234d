// Fused attention for Hopper (sm_90a): the forward and the backward of the
// port's blockwise_attention (src/repro_torch/models/attention.py) on bf16
// inputs.
//
// It replaces no TPU kernel: the JAX package's blockwise_attention
// (src/repro/models/attention.py) is plain JAX, with no Pallas kernel.  The
// port's plain version widens q, k and v to fp32, runs both products as
// fp32 SGEMMs on the CUDA cores, writes every score block to device memory
// and keeps it for the backward; these kernels keep scores and
// probabilities in registers and shared memory, and never write them.
//
// What bounds it on the H100: operations.  At granite's training shape
// (4 sequences of 4,096 tokens, 16 query heads on 8 kv heads of 64, causal)
// one layer's forward reads and writes ~50 MB and does 0.14 TFLOP of
// products (0.21 with the split below), ~180 operations a byte in bf16 and
// far more per byte of device memory than the card's ~295 once the tiles
// are reused from shared memory: the tensor cores set the bound.  So the
// design spends its effort on keeping the products on the tensor cores and
// off masked work:
// - products: mma.sync m16n8k16, bf16 operands, fp32 sums; operands from
//   shared memory by ldmatrix (.trans where the tile is (depth, n)).  q, k,
//   v and dO go in as they arrive.  The plain path multiplies fp32 P by V,
//   and fp32 dS by K and Q; here each such fp32 operand is split into
//   hi = bf16(x) and lo = bf16(x - hi), and both go through the tensor
//   cores into one fp32 sum: ~16 significant bits of the operand where the
//   plain path keeps 24, far below the bf16 rounding of the outputs.  That
//   costs 1.5x the tensor-core work of a bf16-P kernel.
// - the softmax: online (running max, denominator, rescale) in fp32
//   registers, in base 2 (scores times scale * log2(e), exp2f).  The
//   forward writes O in bf16, the row log-sum-exp in fp32 (natural log) and,
//   where gradients are wanted, O in fp32 for the backward's
//   D = rowsum(dO * O).
// - masks: a key tile that the causal or window mask hides from every row
//   of a query tile is never loaded; a tile that every row sees entirely is
//   computed without a per-element mask.  A hidden score contributes
//   exactly 0, as exp(-1e30 - m) does in the plain path.  Causal grids run
//   their longest query tiles first, so the card's SMs finish together.
// - a row that sees no key at all: the wrapper raises before any launch
//   (the plain path would give that row the mean of V); no caller of the
//   registry makes one.
// - tiles: 64 query rows (4 warps of 16) by 64 keys, K/V (forward, dQ) or
//   Q/dO (dK/dV) double-buffered in shared memory by 16-byte cp.async
//   copies.  The head dim picks the instance: 16, 32, 64 or 128 (a head dim
//   between pads with zeros in shared memory); rows are padded by 16 bytes,
//   so ldmatrix reads without bank conflicts.
// - layout: the port's (B, S, H, Dh), read through strides (the head dim
//   contiguous, 16-byte aligned rows).  GQA reads kv head h / (Hq / Hkv)
//   in place: K and V are never repeated.
// - backward, FlashAttention-2's deterministic form: attn_bwd_delta_kernel
//   (D = rowsum(dO * O), fp32); attn_bwd_dkdv_kernel, one block per (64-key
//   tile, batch x kv head), walking the query tiles of every query head of
//   its group; attn_bwd_dq_kernel, one block per (query tile, batch x query
//   head), walking its key tiles.  Both recompute P from the saved
//   log-sum-exp.  No atomics: the same inputs give the same bits on every
//   launch.
//
// Plain C interface, bound with ctypes: the launch parameters travel in
// AttnParams (mirrored by kernels/attention.py), every entry returns the
// first CUDA error of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;   // 4 warps
constexpr int BM = 64;         // query rows of a forward / dQ block
constexpr int BN = 64;         // keys of a tile (forward, dQ) or dK/dV block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

}  // namespace

extern "C" {

// One call's shapes, strides (in elements) and buffers.  Must match
// kernels/attention.py's _Params field for field.
struct AttnParams {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const bf16* dout;         // backward only
    long long q_b, q_s, q_h;
    long long k_b, k_s, k_h;
    long long v_b, v_s, v_h;
    long long do_b, do_s, do_h;
    long long window;         // used where has_window
    long long q_offset;       // query i sits at key position q_offset + i
    int B, Sq, Sk, Hq, Hkv, D;
    int causal, has_window;
    float scale;              // multiplies the scores
    bf16* o;                  // (B, Sq, Hq, D), contiguous
    float* o32;               // the same in fp32, or null
    float* lse;               // (B, Hq, Sq) natural log-sum-exp, or null
    float* delta;             // (B, Hq, Sq) scratch of the backward
    bf16* dq;                 // (B, Sq, Hq, D), contiguous
    bf16* dk;                 // (B, Sk, Hkv, D), contiguous
    bf16* dv;                 // (B, Sk, Hkv, D), contiguous
};

}  // extern "C"

namespace {

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
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

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 h) {
    return *reinterpret_cast<unsigned*>(&h);
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi); x in
// the low half, as the fragments order their two elements
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    float2 hf = __bfloat1622float2(h);
    hi = as_u32(h);
    lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (16 rows x 16 deep) of k step t from the fp32 sums of
// two n8 fragments 2t and 2t + 1 (the m16n8 accumulator layout), split
// into hi and lo.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         unsigned (&hi)[4], unsigned (&lo)[4]) {
    split2(c0[0], c0[1], hi[0], lo[0]);
    split2(c0[2], c0[3], hi[1], lo[1]);
    split2(c1[0], c1[1], hi[2], lo[2]);
    split2(c1[2], c1[3], hi[3], lo[3]);
}

// Load ROWS rows (s0 ...) of one (batch, head) slice of a (B, S, H, D)
// operand into shared memory, row stride DP + 8; rows past S and columns
// past D are zero-filled.
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long s_stride, int s0, int S,
                                          int D) {
    constexpr int CH = DP / 8;
    constexpr int LD = DP + 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
        const int r = i / CH, c = i % CH;
        const bool ok = s0 + r < S && c * 8 < D;
        const bf16* src = ok ? base + (long long)(s0 + r) * s_stride + c * 8
                             : base;
        cp_async16(dst + r * LD + c * 8, src, ok);
    }
}

// Is key position kp visible from query position qp?
__device__ __forceinline__ bool visible(const AttnParams& p, long long qp,
                                        long long kp) {
    return kp < p.Sk && (!p.causal || qp >= kp)
           && (!p.has_window || qp - p.window < kp);
}

// The keys [lo, hi) that some query row of [i0, i1) sees.
__device__ __forceinline__ void key_range(const AttnParams& p, int i0,
                                          int i1, long long& lo,
                                          long long& hi) {
    const long long qp_lo = p.q_offset + i0, qp_hi = p.q_offset + i1 - 1;
    lo = p.has_window ? max(0LL, qp_lo - p.window + 1) : 0LL;
    hi = p.causal ? min((long long)p.Sk, qp_hi + 1) : (long long)p.Sk;
}

// Does the tile of keys [k0, k0 + n) need a per-element mask against the
// query rows [i0, i1)?
__device__ __forceinline__ bool needs_mask(const AttnParams& p, long long k0,
                                           int n, int i0, int i1) {
    const long long qp_lo = p.q_offset + i0, qp_hi = p.q_offset + i1 - 1;
    return k0 + n > p.Sk || (p.causal && k0 + n - 1 > qp_lo)
           || (p.has_window && k0 <= qp_hi - p.window);
}

// -- forward ------------------------------------------------------------------

template <int DP>
constexpr int fwd_smem_bytes() { return (BM + 4 * BN) * (DP + 8) * 2; }

// Grid: x = batch x query head, y = query tile (longest first if causal).
template <int DP>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(AttnParams p) {
    constexpr int LD = DP + 8;
    constexpr int KD = DP / 16;    // k steps over the head dim
    constexpr int ND = DP / 8;     // n8 fragments over the head dim
    constexpr int NK = BN / 8;     // n8 fragments over a key tile
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sq = reinterpret_cast<bf16*>(smem);   // BM x LD
    bf16* sk = sq + BM * LD;                    // 2 stages of BN x LD
    bf16* sv = sk + 2 * BN * LD;                // 2 stages of BN x LD

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
    const int hk = h / (p.Hq / p.Hkv);
    const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int i0 = qt * BM, i1 = min(i0 + BM, p.Sq);
    long long k_lo, k_hi;
    key_range(p, i0, i1, k_lo, k_hi);
    const int t_lo = (int)(k_lo / BN);
    const int t_hi = k_hi > k_lo ? (int)((k_hi + BN - 1) / BN) : t_lo;

    const bf16* qb = p.q + b * p.q_b + h * p.q_h;
    const bf16* kb = p.k + b * p.k_b + hk * p.k_h;
    const bf16* vb = p.v + b * p.v_b + hk * p.v_h;
    load_rows<DP, BM>(sq, qb, p.q_s, i0, p.Sq, p.D);
    if (t_lo < t_hi) {
        load_rows<DP, BN>(sk, kb, p.k_s, t_lo * BN, p.Sk, p.D);
        load_rows<DP, BN>(sv, vb, p.v_s, t_lo * BN, p.Sk, p.D);
    }
    cp_async_commit();

    // this thread's two rows: r and r + 8 of the warp's 16
    const int r0 = warp * 16 + lane / 4;
    const long long qpos[2] = {p.q_offset + i0 + r0,
                               p.q_offset + i0 + r0 + 8};
    float o_acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
        o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};
    unsigned qf[KD][4];
    const float sl2 = p.scale * LOG2E;

    for (int t = t_lo; t < t_hi; ++t) {
        const int st = (t - t_lo) & 1;
        if (t + 1 < t_hi) {
            load_rows<DP, BN>(sk + (st ^ 1) * BN * LD, kb, p.k_s,
                              (t + 1) * BN, p.Sk, p.D);
            load_rows<DP, BN>(sv + (st ^ 1) * BN * LD, vb, p.v_s,
                              (t + 1) * BN, p.Sk, p.D);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (t == t_lo) {
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
                ldsm_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * LD
                                    + kk * 16 + (lane >> 4) * 8);
        }
        const bf16* skt = sk + st * BN * LD;
        const bf16* svt = sv + st * BN * LD;

        // S = Q K^T, 16 rows x 64 keys a warp
        float s[NK][4];
#pragma unroll
        for (int n = 0; n < NK; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
            for (int n2 = 0; n2 < NK / 2; ++n2) {
                unsigned bk[4];
                ldsm_x4(bk, skt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3))
                                      * LD + kk * 16 + ((lane >> 3) & 1) * 8);
                mma_bf16(s[2 * n2], qf[kk], bk[0], bk[1]);
                mma_bf16(s[2 * n2 + 1], qf[kk], bk[2], bk[3]);
            }
        }
        const long long k0 = (long long)t * BN;
        const bool mask = needs_mask(p, k0, BN, i0, i1);
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[n][e] * sl2;
                if (mask && !visible(p, qpos[e >> 1],
                                     k0 + n * 8 + (lane & 3) * 2 + (e & 1)))
                    x = -INFINITY;
                s[n][e] = x;
            }
        // online softmax, per row
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int n = 0; n < NK; ++n)
                mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_r[i], mx);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float corr = exp2f(m_r[i] - m_use);
            m_r[i] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < NK; ++n) {
                s[n][2 * i] = exp2f(s[n][2 * i] - m_use);
                s[n][2 * i + 1] = exp2f(s[n][2 * i + 1] - m_use);
                sum += s[n][2 * i] + s[n][2 * i + 1];
            }
            l_r[i] = l_r[i] * corr + sum;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                o_acc[n][2 * i] *= corr;
                o_acc[n][2 * i + 1] *= corr;
            }
        }
        // O += P V, P split into hi + lo
#pragma unroll
        for (int kt = 0; kt < BN / 16; ++kt) {
            unsigned a_hi[4], a_lo[4];
            acc_to_a(s[2 * kt], s[2 * kt + 1], a_hi, a_lo);
#pragma unroll
            for (int n2 = 0; n2 < ND / 2; ++n2) {
                unsigned bv[4];
                ldsm_x4_trans(bv, svt + (kt * 16 + (lane & 7)
                                         + ((lane >> 3) & 1) * 8) * LD
                                      + n2 * 16 + (lane >> 4) * 8);
                mma_bf16(o_acc[2 * n2], a_hi, bv[0], bv[1]);
                mma_bf16(o_acc[2 * n2 + 1], a_hi, bv[2], bv[3]);
                mma_bf16(o_acc[2 * n2], a_lo, bv[0], bv[1]);
                mma_bf16(o_acc[2 * n2 + 1], a_lo, bv[2], bv[3]);
            }
        }
        __syncthreads();   // the stage is free for the load two tiles on
    }
    cp_async_wait<0>();    // a block with no key tile still loaded Q

    // epilogue: O = acc / l, the row's log-sum-exp
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float l = l_r[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = i0 + r0 + 8 * i;
        if (row >= p.Sq) continue;
        const long long ob = (((long long)b * p.Sq + row) * p.Hq + h) * p.D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            const int d = n * 8 + (lane & 3) * 2;
            if (d >= p.D) continue;
            const float x = o_acc[n][2 * i] / l, y = o_acc[n][2 * i + 1] / l;
            *reinterpret_cast<__nv_bfloat162*>(p.o + ob + d) =
                __floats2bfloat162_rn(x, y);
            if (p.o32)
                *reinterpret_cast<float2*>(p.o32 + ob + d) = make_float2(x, y);
        }
        if (p.lse && (lane & 3) == 0)
            p.lse[((long long)b * p.Hq + h) * p.Sq + row] =
                (m_r[i] + log2f(l)) * LN2;
    }
}

// -- backward -----------------------------------------------------------------

// D = rowsum(dO * O) in fp32, one warp per (batch, query row, query head)
__global__ void __launch_bounds__(THREADS) attn_bwd_delta_kernel(
        AttnParams p) {
    const long long row = (long long)blockIdx.x * (THREADS / 32)
                          + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const long long rows = (long long)p.B * p.Sq * p.Hq;
    if (row >= rows) return;
    const int h = (int)(row % p.Hq);
    const int s = (int)((row / p.Hq) % p.Sq);
    const int b = (int)(row / ((long long)p.Hq * p.Sq));
    const bf16* dob = p.dout + b * p.do_b + s * p.do_s + h * p.do_h;
    const float* ob = p.o32 + row * p.D;
    float acc = 0.f;
    for (int d = lane; d < p.D; d += 32)
        acc += __bfloat162float(dob[d]) * ob[d];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) p.delta[((long long)b * p.Hq + h) * p.Sq + s] = acc;
}

template <int DP>
__host__ __device__ constexpr int bwd_rows() {   // dK/dV query tile
    return DP > 64 ? 32 : 64;
}

template <int DP>
constexpr int dkdv_smem_bytes() {
    return (2 * BN + 4 * bwd_rows<DP>()) * (DP + 8) * 2
           + 4 * bwd_rows<DP>() * 4;
}

// Grid: x = batch x kv head, y = key tile.  Each block walks the query
// tiles (of BR rows) of every query head of its kv head's group that see
// any of its keys, and sums dK and dV over them in registers.
template <int DP>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkdv_kernel(
        AttnParams p) {
    constexpr int BR = bwd_rows<DP>();
    constexpr int LD = DP + 8;
    constexpr int KD = DP / 16;
    constexpr int ND = DP / 8;
    constexpr int NR = BR / 8;     // n8 fragments over a query tile
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sk = reinterpret_cast<bf16*>(smem);   // BN x LD
    bf16* sv = sk + BN * LD;                    // BN x LD
    bf16* sq = sv + BN * LD;                    // 2 stages of BR x LD
    bf16* sdo = sq + 2 * BR * LD;               // 2 stages of BR x LD
    float* slse = reinterpret_cast<float*>(sdo + 2 * BR * LD);  // 2 x BR
    float* sdel = slse + 2 * BR;                                // 2 x BR

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
    const int n_rep = p.Hq / p.Hkv;
    const int k0 = blockIdx.y * BN;
    const int k_last = min(k0 + BN, p.Sk) - 1;
    // the query rows [i_lo, i_hi) that see a key of this tile
    long long i_lo = p.causal ? max(0LL, (long long)k0 - p.q_offset) : 0LL;
    long long i_hi = p.has_window
        ? min((long long)p.Sq, k_last + p.window - p.q_offset)
        : (long long)p.Sq;
    const int qt_lo = (int)(i_lo / BR);
    const int qt_n = i_hi > i_lo ? (int)((i_hi + BR - 1) / BR) - qt_lo : 0;
    const int steps = qt_n * n_rep;

    const bf16* kb = p.k + b * p.k_b + hk * p.k_h;
    const bf16* vb = p.v + b * p.v_b + hk * p.v_h;
    load_rows<DP, BN>(sk, kb, p.k_s, k0, p.Sk, p.D);
    load_rows<DP, BN>(sv, vb, p.v_s, k0, p.Sk, p.D);
    // step j: query head hk * n_rep + j / qt_n, query tile qt_lo + j % qt_n
    auto load_step = [&](int j, int st) {
        const int h = hk * n_rep + j / qt_n;
        const int q0 = (qt_lo + j % qt_n) * BR;
        load_rows<DP, BR>(sq + st * BR * LD, p.q + b * p.q_b + h * p.q_h,
                          p.q_s, q0, p.Sq, p.D);
        load_rows<DP, BR>(sdo + st * BR * LD,
                          p.dout + b * p.do_b + h * p.do_h, p.do_s, q0, p.Sq,
                          p.D);
        const long long rb = ((long long)b * p.Hq + h) * p.Sq;
        for (int r = threadIdx.x; r < BR; r += THREADS) {
            const bool ok = q0 + r < p.Sq;
            cp_async4(slse + st * BR + r, p.lse + (ok ? rb + q0 + r : 0), ok);
            cp_async4(sdel + st * BR + r, p.delta + (ok ? rb + q0 + r : 0),
                      ok);
        }
    };
    if (steps > 0) load_step(0, 0);
    cp_async_commit();

    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    // this thread's two keys: r and r + 8 of the warp's 16
    const int kr = warp * 16 + lane / 4;
    const long long kpos[2] = {k0 + kr, k0 + kr + 8};
    const float sl2 = p.scale * LOG2E;

    for (int j = 0; j < steps; ++j) {
        const int st = j & 1;
        if (j + 1 < steps) {
            load_step(j + 1, st ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* sqt = sq + st * BR * LD;
        const bf16* sdot = sdo + st * BR * LD;
        const float* lse = slse + st * BR;
        const float* del = sdel + st * BR;
        const int q0 = (qt_lo + j % qt_n) * BR;

        // S^T = K Q^T and dP^T = V dO^T, 16 keys x BR queries a warp
        float s[NR][4], dp[NR][4];
#pragma unroll
        for (int n = 0; n < NR; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            unsigned ka[4], va[4];
            ldsm_x4(ka, sk + (warp * 16 + (lane & 15)) * LD + kk * 16
                            + (lane >> 4) * 8);
            ldsm_x4(va, sv + (warp * 16 + (lane & 15)) * LD + kk * 16
                            + (lane >> 4) * 8);
#pragma unroll
            for (int n2 = 0; n2 < NR / 2; ++n2) {
                const int off = (n2 * 16 + (lane & 7) + ((lane >> 4) << 3))
                                * LD + kk * 16 + ((lane >> 3) & 1) * 8;
                unsigned bq[4], bd[4];
                ldsm_x4(bq, sqt + off);
                ldsm_x4(bd, sdot + off);
                mma_bf16(s[2 * n2], ka, bq[0], bq[1]);
                mma_bf16(s[2 * n2 + 1], ka, bq[2], bq[3]);
                mma_bf16(dp[2 * n2], va, bd[0], bd[1]);
                mma_bf16(dp[2 * n2 + 1], va, bd[2], bd[3]);
            }
        }
        // P^T from the log-sum-exp; dS^T = P^T (dP^T - D); s holds P^T,
        // dp holds dS^T
        const bool mask = needs_mask(p, k0, BN, q0, min(q0 + BR, p.Sq));
#pragma unroll
        for (int n = 0; n < NR; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = n * 8 + (lane & 3) * 2 + (e & 1);
                float pr = exp2f(fmaf(s[n][e], sl2, -lse[c] * LOG2E));
                if (mask && !visible(p, p.q_offset + q0 + c, kpos[e >> 1]))
                    pr = 0.f;
                s[n][e] = pr;
                dp[n][e] = pr * (dp[n][e] - del[c]);
            }
        // dV += P^T dO and dK += dS^T Q, the fp32 operands split
#pragma unroll
        for (int kt = 0; kt < BR / 16; ++kt) {
            unsigned p_hi[4], p_lo[4], d_hi[4], d_lo[4];
            acc_to_a(s[2 * kt], s[2 * kt + 1], p_hi, p_lo);
            acc_to_a(dp[2 * kt], dp[2 * kt + 1], d_hi, d_lo);
#pragma unroll
            for (int n2 = 0; n2 < ND / 2; ++n2) {
                const int off = (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                * LD + n2 * 16 + (lane >> 4) * 8;
                unsigned bd[4], bq[4];
                ldsm_x4_trans(bd, sdot + off);
                ldsm_x4_trans(bq, sqt + off);
                mma_bf16(dv[2 * n2], p_hi, bd[0], bd[1]);
                mma_bf16(dv[2 * n2 + 1], p_hi, bd[2], bd[3]);
                mma_bf16(dv[2 * n2], p_lo, bd[0], bd[1]);
                mma_bf16(dv[2 * n2 + 1], p_lo, bd[2], bd[3]);
                mma_bf16(dk[2 * n2], d_hi, bq[0], bq[1]);
                mma_bf16(dk[2 * n2 + 1], d_hi, bq[2], bq[3]);
                mma_bf16(dk[2 * n2], d_lo, bq[0], bq[1]);
                mma_bf16(dk[2 * n2 + 1], d_lo, bq[2], bq[3]);
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();    // a block no query sees still loaded K and V

    // dK = scale * sum dS^T Q, dV; keys no query sees get zeros
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long key = kpos[i];
        if (key >= p.Sk) continue;
        const long long ob = (((long long)b * p.Sk + key) * p.Hkv + hk) * p.D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            const int d = n * 8 + (lane & 3) * 2;
            if (d >= p.D) continue;
            *reinterpret_cast<__nv_bfloat162*>(p.dk + ob + d) =
                __floats2bfloat162_rn(dk[n][2 * i] * p.scale,
                                      dk[n][2 * i + 1] * p.scale);
            *reinterpret_cast<__nv_bfloat162*>(p.dv + ob + d) =
                __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
        }
    }
}

template <int DP>
constexpr int dq_smem_bytes() { return (2 * BM + 4 * BN) * (DP + 8) * 2; }

// Grid: x = batch x query head, y = query tile (longest first if causal).
template <int DP>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(AttnParams p) {
    constexpr int LD = DP + 8;
    constexpr int KD = DP / 16;
    constexpr int ND = DP / 8;
    constexpr int NK = BN / 8;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sq = reinterpret_cast<bf16*>(smem);   // BM x LD
    bf16* sdo = sq + BM * LD;                   // BM x LD
    bf16* sk = sdo + BM * LD;                   // 2 stages of BN x LD
    bf16* sv = sk + 2 * BN * LD;                // 2 stages of BN x LD

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
    const int hk = h / (p.Hq / p.Hkv);
    const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int i0 = qt * BM, i1 = min(i0 + BM, p.Sq);
    long long k_lo, k_hi;
    key_range(p, i0, i1, k_lo, k_hi);
    const int t_lo = (int)(k_lo / BN);
    const int t_hi = k_hi > k_lo ? (int)((k_hi + BN - 1) / BN) : t_lo;

    const bf16* kb = p.k + b * p.k_b + hk * p.k_h;
    const bf16* vb = p.v + b * p.v_b + hk * p.v_h;
    load_rows<DP, BM>(sq, p.q + b * p.q_b + h * p.q_h, p.q_s, i0, p.Sq, p.D);
    load_rows<DP, BM>(sdo, p.dout + b * p.do_b + h * p.do_h, p.do_s, i0,
                      p.Sq, p.D);
    if (t_lo < t_hi) {
        load_rows<DP, BN>(sk, kb, p.k_s, t_lo * BN, p.Sk, p.D);
        load_rows<DP, BN>(sv, vb, p.v_s, t_lo * BN, p.Sk, p.D);
    }
    cp_async_commit();

    const int r0 = warp * 16 + lane / 4;
    const long long qpos[2] = {p.q_offset + i0 + r0,
                               p.q_offset + i0 + r0 + 8};
    float lse2[2], del[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = i0 + r0 + 8 * i;
        const long long at = ((long long)b * p.Hq + h) * p.Sq + row;
        lse2[i] = row < p.Sq ? p.lse[at] * LOG2E : 0.f;
        del[i] = row < p.Sq ? p.delta[at] : 0.f;
    }
    float dq[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
        dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    const float sl2 = p.scale * LOG2E;

    for (int t = t_lo; t < t_hi; ++t) {
        const int st = (t - t_lo) & 1;
        if (t + 1 < t_hi) {
            load_rows<DP, BN>(sk + (st ^ 1) * BN * LD, kb, p.k_s,
                              (t + 1) * BN, p.Sk, p.D);
            load_rows<DP, BN>(sv + (st ^ 1) * BN * LD, vb, p.v_s,
                              (t + 1) * BN, p.Sk, p.D);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* skt = sk + st * BN * LD;
        const bf16* svt = sv + st * BN * LD;

        // S = Q K^T and dP = dO V^T, 16 rows x 64 keys a warp
        float s[NK][4], dp[NK][4];
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            unsigned qa[4], da[4];
            const int aoff = (warp * 16 + (lane & 15)) * LD + kk * 16
                             + (lane >> 4) * 8;
            ldsm_x4(qa, sq + aoff);
            ldsm_x4(da, sdo + aoff);
#pragma unroll
            for (int n2 = 0; n2 < NK / 2; ++n2) {
                const int off = (n2 * 16 + (lane & 7) + ((lane >> 4) << 3))
                                * LD + kk * 16 + ((lane >> 3) & 1) * 8;
                unsigned bk[4], bv[4];
                ldsm_x4(bk, skt + off);
                ldsm_x4(bv, svt + off);
                mma_bf16(s[2 * n2], qa, bk[0], bk[1]);
                mma_bf16(s[2 * n2 + 1], qa, bk[2], bk[3]);
                mma_bf16(dp[2 * n2], da, bv[0], bv[1]);
                mma_bf16(dp[2 * n2 + 1], da, bv[2], bv[3]);
            }
        }
        const long long k0 = (long long)t * BN;
        const bool mask = needs_mask(p, k0, BN, i0, i1);
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float pr = exp2f(fmaf(s[n][e], sl2, -lse2[e >> 1]));
                if (mask && !visible(p, qpos[e >> 1],
                                     k0 + n * 8 + (lane & 3) * 2 + (e & 1)))
                    pr = 0.f;
                dp[n][e] = pr * (dp[n][e] - del[e >> 1]);   // dS
            }
        // dQ += dS K, dS split
#pragma unroll
        for (int kt = 0; kt < BN / 16; ++kt) {
            unsigned a_hi[4], a_lo[4];
            acc_to_a(dp[2 * kt], dp[2 * kt + 1], a_hi, a_lo);
#pragma unroll
            for (int n2 = 0; n2 < ND / 2; ++n2) {
                unsigned bk[4];
                ldsm_x4_trans(bk, skt + (kt * 16 + (lane & 7)
                                         + ((lane >> 3) & 1) * 8) * LD
                                      + n2 * 16 + (lane >> 4) * 8);
                mma_bf16(dq[2 * n2], a_hi, bk[0], bk[1]);
                mma_bf16(dq[2 * n2 + 1], a_hi, bk[2], bk[3]);
                mma_bf16(dq[2 * n2], a_lo, bk[0], bk[1]);
                mma_bf16(dq[2 * n2 + 1], a_lo, bk[2], bk[3]);
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = i0 + r0 + 8 * i;
        if (row >= p.Sq) continue;
        const long long ob = (((long long)b * p.Sq + row) * p.Hq + h) * p.D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            const int d = n * 8 + (lane & 3) * 2;
            if (d >= p.D) continue;
            *reinterpret_cast<__nv_bfloat162*>(p.dq + ob + d) =
                __floats2bfloat162_rn(dq[n][2 * i] * p.scale,
                                      dq[n][2 * i + 1] * p.scale);
        }
    }
}

// -- host ---------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int smem, const AttnParams& p,
                   cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int DP>
cudaError_t forward(const AttnParams& p, cudaStream_t stream) {
    dim3 grid(p.B * p.Hq, (p.Sq + BM - 1) / BM);
    return launch(attn_fwd_kernel<DP>, grid, fwd_smem_bytes<DP>(), p, stream);
}

template <int DP>
cudaError_t backward(const AttnParams& p, cudaStream_t stream) {
    const long long rows = (long long)p.B * p.Sq * p.Hq;
    attn_bwd_delta_kernel<<<(unsigned)((rows + 3) / 4), THREADS, 0,
                            stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch(attn_bwd_dkdv_kernel<DP>,
                 dim3(p.B * p.Hkv, (p.Sk + BN - 1) / BN),
                 dkdv_smem_bytes<DP>(), p, stream);
    if (err != cudaSuccess) return err;
    return launch(attn_bwd_dq_kernel<DP>,
                  dim3(p.B * p.Hq, (p.Sq + BM - 1) / BM), dq_smem_bytes<DP>(),
                  p, stream);
}

}  // namespace

extern "C" {

// The forward: o (and o32, lse where not null).  Head dims 16..128 in
// steps of 16; the wrapper checks shapes, strides and alignment.
int flexagon_attn_fwd(const AttnParams* p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p->D <= 16) return forward<16>(*p, s);
    if (p->D <= 32) return forward<32>(*p, s);
    if (p->D <= 64) return forward<64>(*p, s);
    if (p->D <= 128) return forward<128>(*p, s);
    return cudaErrorInvalidValue;
}

// The backward: delta, then dk and dv, then dq, from q, k, v, dout, o32
// and lse.
int flexagon_attn_bwd(const AttnParams* p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p->D <= 16) return backward<16>(*p, s);
    if (p->D <= 32) return backward<32>(*p, s);
    if (p->D <= 64) return backward<64>(*p, s);
    if (p->D <= 128) return backward<128>(*p, s);
    return cudaErrorInvalidValue;
}

const char* flexagon_attn_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
