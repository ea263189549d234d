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
// Both kernels run one device walk (walk_chunk): a list of segments, each
// the entries that sum into one output tile (ci, cj), in order.  The host
// cuts each segment's entries into chunks (DeviceSchedule's chunk tables,
// built once per plan), so that a plan with few long segments still fills
// the 132 SMs: the 4-token FFN down projection's 12 runs of 35 entries
// become 108 chunks.  The grid is (chunk, sub-tile of one (bm, bn) block).
// One CUDA block sums its chunk's entries in order, k in order within an
// entry.  A segment of one chunk writes its sub-tile straight into the
// zeroed C, cropped to (M, N); a segment of several writes each chunk's
// partial tile to a workspace slot, and a second pass of the same call
// (reduce_split) sums the slots in chunk order and writes C.  A segment
// whose destination row is out of bounds (a pad run from pad_schedule) is
// skipped, as the JAX scatter drops it.
//
// K1 (destination-major; IP and OP): a segment is one run of the schedule,
// and its destination block (ci, cj) comes from the host.
//
// K2 (row panel; Gustavson): a run is one output block row, whose
// (bm, Nb*bn) panel (6.2 MB at N = 12100, bm = 128) does not fit in shared
// memory.  The host regroups each run's entries by destination column
// block (DeviceSchedule's column table): a column segment holds the
// entries of one run that add into one column block, in work-list order,
// so each output element is summed in the order the TPU kernel adds it.
// A column segment is a K1 segment, and K2 walks the column table with
// its own chunks, second pass and kernel names.  A tile that no entry
// touches gets no CUDA block and stays zero; pad runs have no column
// segment.
//
// The sub-tile is TM x CN with TM = 16, 32 or 64, chosen by the host as the
// least that covers a block's valid rows, min(bm, M): 4 decode tokens in a
// 128-row block compute 16 rows, not 64.  Rows past M are neither loaded
// nor written.  CN is 64 in K1; in K2 it is 32 where bn <= 32 (Table 6's
// 32-blocks, where a 64-wide sub-tile leaves half its threads idle), else
// 64.  The A and B slices of the chunk's entries stream through a ring of
// STAGES shared-memory slots, each TK deep, filled with cp.async (16-byte
// copies where rows are 16-byte aligned, else 4-byte ones) while the block
// multiplies the slot that has landed, so the next slices' loads are in
// flight during the current slice's FMAs, across entry boundaries.
//
// B comes in one of two forms, fixed per kernel instance (IN_PLACE):
// a stack of (bk, bn) blocks, gathered beforehand, or the dense (K, N)
// operand itself, read in place: B slot s is then the block at block row
// b_row[s] and block column b_col[s], rows ldb floats apart, and its rows
// past K load as zeros, as the stack's padding does.  Both forms feed the
// same slices to the same sums, so they give the same bits; the in-place
// form saves the gather's write and second read of every present block.
//
// What bounds them on the H100: the products run on the CUDA cores in fp32
// (67 TFLOP/s on the data sheet), not on the tensor cores, to keep fp32
// parity with the reference.  Each work entry moves (bm*bk + bk*bn)*4 bytes
// for 2*bm*bk*bn operations: 8 operations a byte at 32-blocks, below the
// card's 20 fp32 operations a byte of device memory, so small blocks and
// few valid rows (decode) are bound by bytes, full 128-blocks by
// operations.  Each of 256 threads keeps a (TM/16) x (CN/16) register
// tile, and reads A four k at a time from shared memory.
//
// Plain C interface, bound with ctypes: every pointer and the stream are
// void*, and each entry returns the first CUDA error of its launches.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads, every kernel
constexpr int TK = 32;         // depth of one pipeline slice
constexpr int STAGES = 4;      // ring slots: 3 slices in flight
constexpr int LDA = TK + 4;    // A slot row stride (floats): float4 reads
                               // of two rows hit other banks

// One walk of a kernel call: its segments, their chunks, and where the
// sums go.  K1 passes a schedule's runs, K2 its column segments.
struct Walk {
    const float* a;            // (nnzb, bm, bk) A blocks, row-major
    const float* b;            // (nnzb, bk, bn) B blocks, row-major
    const int* a_slot;         // (V,) A block of each entry
    const int* b_slot;         // (V,) B block of each entry
    const int* chunk_start;    // (C+1,) chunk offsets among the entries
    const int* chunk_seg;      // (C,) each chunk's segment
    const int* chunk_slot;     // (C,) its workspace slot, or -1: write C
    const int* seg_ci;         // (S,) destination block row
    const int* seg_cj;         // (S,) destination block column
    const int* split_seg;      // (P,) segments cut into several chunks
    const int* split_start;    // (P+1,) each one's first workspace slot
    float* part;               // (slots, bm, bn) partial tiles
    float* c;                  // (M, N) output, zeroed by the caller
    int bm, bk, bn, mb, M, N;
    int tiles_n;               // column sub-tiles of one (bm, bn) block
    int vec;                   // 16-byte copies are aligned
    // B read in place (b is the dense (K, N) operand); unused on a stack
    const int* b_row;          // (nnzb,) block row of each B slot
    const int* b_col;          // (nnzb,) block column of each B slot
    int K;                     // B's rows
    int ldb;                   // B's row stride (floats)
};

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

template <int RI, int CN>
constexpr int smem_bytes() {
    return STAGES * (16 * RI * LDA + TK * CN) * 4;
}

// One CUDA block: chunk blockIdx.x of the walk, on sub-tile blockIdx.y
// ((16 RI) x CN) of its segment's (bm, bn) tile.  IN_PLACE: B is the
// dense operand (see the head of the file).
template <int RI, int CN, bool IN_PLACE>
__device__ __forceinline__ void walk_chunk(const Walk& w, float* smem) {
    constexpr int TM = 16 * RI, CJ = CN / 16;   // thread tile RI x CJ
    constexpr int A_STAGE = TM * LDA, B_STAGE = TK * CN;
    float* as = smem;
    float* bs = smem + STAGES * A_STAGE;

    const int ch = blockIdx.x;
    const int s = w.chunk_seg[ch];
    const int ci = w.seg_ci[s];
    if (ci < 0 || ci >= w.mb) return;           // pad run: dropped
    const int m0 = (blockIdx.y / w.tiles_n) * TM;
    const int n0 = (blockIdx.y % w.tiles_n) * CN;
    const int row0 = ci * w.bm + m0;
    const int col0 = w.seg_cj[s] * w.bn + n0;
    if (m0 >= w.bm || row0 >= w.M || col0 >= w.N) return;  // in the padding
    // the rows and columns that reach C; B loads whole 4-float chunks,
    // which stay inside the block when bn % 4 == 0
    const int tm = min(min(TM, w.bm - m0), w.M - row0);
    const int tn = min(min(CN, w.bn - n0), w.N - col0);

    const int bk = w.bk, bn = w.bn;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int w0 = w.chunk_start[ch];
    const int per = (bk + TK - 1) / TK;         // slices per entry
    const int nsl = (w.chunk_start[ch + 1] - w0) * per;
    const size_t a_stride = (size_t)w.bm * bk, b_stride = (size_t)bk * bn;

    // slice t of the chunk (entry t / per, depth (t % per) * TK) -> slot
    auto load = [&](int slot, int t) {
        const int e = w0 + t / per, k0 = (t % per) * TK;
        const float* ab = w.a + w.a_slot[e] * a_stride + (size_t)m0 * bk;
        // the B block's first row, its rows that exist, their stride
        const float* bb;
        int kv;
        size_t ldb;
        if constexpr (IN_PLACE) {
            const int sb = w.b_slot[e], r0 = w.b_row[sb] * bk;
            ldb = (size_t)w.ldb;
            bb = w.b + (size_t)r0 * ldb + (size_t)w.b_col[sb] * bn + n0;
            kv = min(bk, w.K - r0);
        } else {
            bb = w.b + w.b_slot[e] * b_stride + n0;
            kv = bk;
            ldb = (size_t)bn;
        }
        float* ad = as + slot * A_STAGE;
        float* bd = bs + slot * B_STAGE;
        for (int q = tid; q < TM * (TK / 4); q += THREADS) {
            const int r = q / (TK / 4), k = (q % (TK / 4)) * 4;
            const float* src = ab + (size_t)r * bk + k0 + k;
            float* dst = ad + r * LDA + k;
            if (w.vec) {
                const bool ok = r < tm && k0 + k < bk;
                cp_async16(dst, ok ? src : ab, ok);
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const bool ok = r < tm && k0 + k + u < bk;
                    cp_async4(dst + u, ok ? src + u : ab, ok);
                }
            }
        }
        for (int q = tid; q < TK * (CN / 4); q += THREADS) {
            const int k = q / (CN / 4), cc = (q % (CN / 4)) * 4;
            const float* src = bb + (size_t)(k0 + k) * ldb + cc;
            float* dst = bd + k * CN + cc;
            if (w.vec) {
                const bool ok = k0 + k < kv && cc < tn;
                cp_async16(dst, ok ? src : bb, ok);
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const bool ok = k0 + k < kv && cc + u < tn;
                    cp_async4(dst + u, ok ? src + u : bb, ok);
                }
            }
        }
    };

    float acc[RI][CJ] = {};
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < nsl) load(t, t);
        cp_async_commit();
    }
    for (int t = 0; t < nsl; ++t) {
        cp_async_wait<STAGES - 2>();            // slice t has landed
        __syncthreads();                        // ... and slot t-1 is free
        const int next = t + STAGES - 1;
        if (next < nsl) load(next % STAGES, next);
        cp_async_commit();

        const float* ad = as + (t % STAGES) * A_STAGE;
        const float* bd = bs + (t % STAGES) * B_STAGE;
#pragma unroll
        for (int kk = 0; kk < TK; kk += 4) {
            float4 av[RI];
#pragma unroll
            for (int i = 0; i < RI; ++i)
                av[i] = *reinterpret_cast<const float4*>(
                    ad + (ty + 16 * i) * LDA + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float bv[CJ];
#pragma unroll
                for (int j = 0; j < CJ; ++j)
                    bv[j] = bd[(kk + q) * CN + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    const float ak = q == 0 ? av[i].x : q == 1 ? av[i].y
                                   : q == 2 ? av[i].z : av[i].w;
#pragma unroll
                    for (int j = 0; j < CJ; ++j)
                        acc[i][j] = fmaf(ak, bv[j], acc[i][j]);
                }
            }
        }
    }
    cp_async_wait<0>();

    // a segment of one chunk writes C; else this chunk's workspace slot
    const int slot = w.chunk_slot[ch];
    float* dst = slot < 0
        ? w.c + (size_t)row0 * w.N + col0
        : w.part + (size_t)slot * w.bm * bn + (size_t)m0 * bn + n0;
    const size_t ld = slot < 0 ? (size_t)w.N : (size_t)bn;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        if (r >= tm) continue;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
            const int cc = tx + 16 * j;
            if (cc < tn) dst[r * ld + cc] = acc[i][j];
        }
    }
}

// The second pass: grid (split segments, element blocks of one (bm, bn)
// block, grid-stride).  Each element of a split segment's tile is its
// chunks' slots summed in chunk order.
__device__ __forceinline__ void reduce_split(const Walk& w) {
    const int p = blockIdx.x;
    const int s = w.split_seg[p];
    const int ci = w.seg_ci[s];
    if (ci < 0 || ci >= w.mb) return;
    const size_t tile = (size_t)w.bm * w.bn;
    for (size_t idx = (size_t)blockIdx.y * THREADS + threadIdx.x; idx < tile;
         idx += (size_t)gridDim.y * THREADS) {
        const int row = ci * w.bm + (int)(idx / w.bn);
        const int col = w.seg_cj[s] * w.bn + (int)(idx % w.bn);
        if (row >= w.M || col >= w.N) continue;
        float sum = 0.0f;
        for (int q = w.split_start[p]; q < w.split_start[p + 1]; ++q)
            sum += w.part[q * tile + idx];
        w.c[(size_t)row * w.N + col] = sum;
    }
}

// K1: a schedule's runs; sub-tiles (16 RI) x 64.
template <int RI, bool IN_PLACE>
__global__ void __launch_bounds__(THREADS) stream_dest_kernel(
        const __grid_constant__ Walk w) {
    extern __shared__ __align__(16) float dest_smem[];
    walk_chunk<RI, 64, IN_PLACE>(w, dest_smem);
}

__global__ void __launch_bounds__(THREADS) stream_reduce_kernel(
        const __grid_constant__ Walk w) {
    reduce_split(w);
}

// K2: a panel schedule's column segments; sub-tiles (16 RI) x CN.
template <int RI, int CN, bool IN_PLACE>
__global__ void __launch_bounds__(THREADS) stream_panel_kernel(
        const __grid_constant__ Walk w) {
    extern __shared__ __align__(16) float panel_smem[];
    walk_chunk<RI, CN, IN_PLACE>(w, panel_smem);
}

__global__ void __launch_bounds__(THREADS) stream_panel_reduce_kernel(
        const __grid_constant__ Walk w) {
    reduce_split(w);
}

using WalkKernel = void (*)(Walk);

template <int RI, int CN>
int launch_walk(WalkKernel kernel, Walk w, int n_chunk,
                cudaStream_t stream) {
    constexpr int smem = smem_bytes<RI, CN>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles_m = (min(w.bm, w.M) + 16 * RI - 1) / (16 * RI);
    w.tiles_n = (w.bn + CN - 1) / CN;
    // in place, a 16-byte copy must also start a row at a multiple of 4
    // floats and end at or before N
    w.vec = w.bk % 4 == 0 && w.bn % 4 == 0 && (uintptr_t)w.a % 16 == 0
        && (uintptr_t)w.b % 16 == 0
        && (w.b_row == nullptr || (w.ldb % 4 == 0 && w.N % 4 == 0));
    const dim3 grid(n_chunk, tiles_m * w.tiles_n);
    kernel<<<grid, THREADS, smem, stream>>>(w);
    return (int)cudaGetLastError();
}

int launch_reduce(WalkKernel kernel, const Walk& w, int n_split,
                  cudaStream_t stream) {
    const long long elem_blocks = ((long long)w.bm * w.bn + THREADS - 1)
        / THREADS;
    const dim3 grid(n_split, (unsigned)(elem_blocks < 1024 ? elem_blocks
                                                           : 1024));
    kernel<<<grid, THREADS, 0, stream>>>(w);
    return (int)cudaGetLastError();
}

// K1's sub-tile rows
template <bool IN_PLACE>
int launch_dest(int rows, const Walk& w, int n_chunk, cudaStream_t s) {
    if (rows == 16)
        return launch_walk<1, 64>(stream_dest_kernel<1, IN_PLACE>, w,
                                  n_chunk, s);
    if (rows == 32)
        return launch_walk<2, 64>(stream_dest_kernel<2, IN_PLACE>, w,
                                  n_chunk, s);
    if (rows == 64)
        return launch_walk<4, 64>(stream_dest_kernel<4, IN_PLACE>, w,
                                  n_chunk, s);
    return (int)cudaErrorInvalidValue;
}

// K2's sub-tile rows; its column width: 32 where the block is at most 32
// wide
template <int CN, bool IN_PLACE>
int launch_panel(int rows, const Walk& w, int n_chunk, cudaStream_t s) {
    if (rows == 16)
        return launch_walk<1, CN>(stream_panel_kernel<1, CN, IN_PLACE>, w,
                                  n_chunk, s);
    if (rows == 32)
        return launch_walk<2, CN>(stream_panel_kernel<2, CN, IN_PLACE>, w,
                                  n_chunk, s);
    if (rows == 64)
        return launch_walk<4, CN>(stream_panel_kernel<4, CN, IN_PLACE>, w,
                                  n_chunk, s);
    return (int)cudaErrorInvalidValue;
}

Walk make_walk(const void* a, const void* b, const void* a_slot,
               const void* b_slot, const void* chunk_start,
               const void* chunk_seg, const void* chunk_slot,
               const void* seg_ci, const void* seg_cj, const void* split_seg,
               const void* split_start, void* part, int bm, int bk, int bn,
               int mb, void* c, int M, int N, const void* b_row,
               const void* b_col, int K, int ldb) {
    Walk w;
    w.a = (const float*)a;
    w.b = (const float*)b;
    w.a_slot = (const int*)a_slot;
    w.b_slot = (const int*)b_slot;
    w.chunk_start = (const int*)chunk_start;
    w.chunk_seg = (const int*)chunk_seg;
    w.chunk_slot = (const int*)chunk_slot;
    w.seg_ci = (const int*)seg_ci;
    w.seg_cj = (const int*)seg_cj;
    w.split_seg = (const int*)split_seg;
    w.split_start = (const int*)split_start;
    w.part = (float*)part;
    w.c = (float*)c;
    w.bm = bm;
    w.bk = bk;
    w.bn = bn;
    w.mb = mb;
    w.M = M;
    w.N = N;
    w.tiles_n = 0;
    w.vec = 0;
    w.b_row = (const int*)b_row;
    w.b_col = (const int*)b_col;
    w.K = K;
    w.ldb = ldb;
    return w;
}

}  // namespace

// Both entries take one walk: its entries' block slots, its chunk table
// (chunk_start, chunk_seg, chunk_slot), its segments' destinations
// (seg_ci, seg_cj) and split table (split_seg, split_start), all from
// DeviceSchedule.  part holds one (bm, bn) fp32 slot per chunk of a split
// segment (null when n_split is 0, and then the second pass does not run).
// rows (16, 32 or 64): the sub-tile's row extent, from the wrapper.
// b_row and b_col null: b is a block stack; else b is the dense (K, N)
// operand with row stride ldb, read in place through them.

// K1: the entries and segments are the schedule's own.
extern "C" int flexagon_stream_spmm(
        const void* a, const void* b, const void* a_slot, const void* b_slot,
        const void* chunk_start, const void* chunk_seg, const void* chunk_slot,
        const void* seg_ci, const void* seg_cj, const void* split_seg,
        const void* split_start, void* part, int n_chunk, int n_split,
        int rows, int bm, int bk, int bn, int mb, void* c, int M, int N,
        const void* b_row, const void* b_col, int K, int ldb,
        void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (n_split > 0 && part == nullptr) return (int)cudaErrorInvalidValue;
    const Walk w = make_walk(a, b, a_slot, b_slot, chunk_start, chunk_seg,
                             chunk_slot, seg_ci, seg_cj, split_seg,
                             split_start, part, bm, bk, bn, mb, c, M, N,
                             b_row, b_col, K, ldb);
    const int err = b_row ? launch_dest<true>(rows, w, n_chunk, s)
                          : launch_dest<false>(rows, w, n_chunk, s);
    if (err || n_split == 0) return err;
    return launch_reduce(stream_reduce_kernel, w, n_split, s);
}

// K2: the entries and segments are the column table's (col_ci and col_cj
// as seg_ci and seg_cj).
extern "C" int flexagon_stream_panel_spmm(
        const void* a, const void* b, const void* a_slot, const void* b_slot,
        const void* chunk_start, const void* chunk_seg, const void* chunk_slot,
        const void* col_ci, const void* col_cj, const void* split_seg,
        const void* split_start, void* part, int n_chunk, int n_split,
        int rows, int bm, int bk, int bn, int mb, void* c, int M, int N,
        const void* b_row, const void* b_col, int K, int ldb,
        void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (n_split > 0 && part == nullptr) return (int)cudaErrorInvalidValue;
    const Walk w = make_walk(a, b, a_slot, b_slot, chunk_start, chunk_seg,
                             chunk_slot, col_ci, col_cj, split_seg,
                             split_start, part, bm, bk, bn, mb, c, M, N,
                             b_row, b_col, K, ldb);
    int err;
    if (b_row)
        err = bn <= 32 ? launch_panel<32, true>(rows, w, n_chunk, s)
                       : launch_panel<64, true>(rows, w, n_chunk, s);
    else
        err = bn <= 32 ? launch_panel<32, false>(rows, w, n_chunk, s)
                       : launch_panel<64, false>(rows, w, n_chunk, s);
    if (err || n_split == 0) return err;
    return launch_reduce(stream_panel_reduce_kernel, w, n_split, s);
}

extern "C" const char* flexagon_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
