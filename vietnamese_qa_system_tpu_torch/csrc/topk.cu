// Fused matmul + exact streaming top-k for Hopper (sm_90a).
//
// Replaces the Pallas kernels of vietnamese_qa_system_tpu/ops/topk.py:
//   K1  _fast_kernel_bf16 / _exact_kernel_bf16   bf16 corpus, f32 scores
//   K2  _fast_kernel_int8                        int8 corpus, raw * scale[row]
//   K3  _fast_kernel_int8_global                 int8 corpus, raw int32 scores
//
// What bounds it on an H100: at the serving shape (B=256 queries, D=768,
// N=1M rows) the scan does 2*B*D*N = 403 GFLOP against 1.5 GB (bf16) or
// 0.8 GB (int8) of corpus, about 256 operations per byte -- next to the
// card's bf16 ridge (~295 op/byte), so both the tensor cores and HBM matter.
// Selection is cheap by comparison once a per-query threshold filters the
// scores: on random data only ~k*ln(N/k) scores per query ever enter a list.
// Measured on the H100 (PERF.md): this design moves ~2.45 TB/s of operand
// bytes from L2 into shared memory in every tile shape tried, and each
// query tile re-reads the corpus chunk and its query chunk (0.047 bytes per
// MAC at bf16), so the bytes moved into the SMs -- not HBM, not the tensor
// cores -- bound it; larger tiles with register-resident scores, or TMA
// multicast of corpus chunks across a cluster, are the way to go faster.
//
// Design:
// - Grid (query tiles of QB=64, corpus splits).  Each block streams its
//   corpus range in NB=128-row tiles; the 64x128 score tile is a WMMA
//   (bf16 -> f32 or int8 -> int32) product accumulated over the feature
//   dimension in 128-byte chunks through a 2-slot cp.async ring.
// - The TPU's lane-bucket selection (topk.py:93-330) is not carried over.
//   Every mode is exact: each block keeps a sorted per-query top-k list in
//   shared memory ordered by (score desc, index asc); one warp per query
//   row ballots the scores that beat the row's k-th entry and inserts them.
// - Blocks write (B, splits, k) candidates; topk_merge_kernel picks the
//   final k per query with k rounds of a block-wide argmax.
// - Rows >= valid_n are never read: splits cover [0, valid_n) only.
// The query quantisation (int8) and the final per-query scaling stay in
// the Python wrapper, as they do in the JAX package.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <climits>
#include <math.h>

using namespace nvcuda;

namespace {

constexpr int QB = 64;          // queries per block
constexpr int NB = 128;         // corpus rows per tile
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LDS = NB + 4;     // score tile row stride, 32-bit words
constexpr int MAX_K = 256;
constexpr int KSLOTS = MAX_K / 32;
constexpr int CHUNK_BYTES = 128;  // feature bytes per row per pipeline stage
constexpr int VECS = CHUNK_BYTES / 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 2;             // cp.async ring depth (3 and 4 measured no faster)
constexpr int WARPS_M = 2;            // warp grid over the QB x NB tile: 32 x 32 per warp
constexpr int WARPS_N = WARPS / WARPS_M;
constexpr int FM = QB / WARPS_M / 16;  // 16x16 fragments per warp
constexpr int FN = NB / WARPS_N / 16;

enum Epilogue { EPI_F32 = 0, EPI_ROW_SCALE = 1, EPI_RAW = 2 };

template <typename T> struct Acc;
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<signed char> { using type = int; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// (s, i) ranks before (t, j): higher score first, then lower index.
__device__ __forceinline__ bool beats(float s, int i, float t, int j) {
    return s > t || (s == t && i < j);
}

// Insert (cs, cn) into the sorted list (ls, li) of length k if it ranks
// before the last entry.  Called by a whole warp with uniform arguments.
__device__ __forceinline__ void list_insert(float* ls, int* li, int k, float cs, int cn, int lane) {
    if (!beats(cs, cn, ls[k - 1], li[k - 1])) return;
    int cnt = 0;
    for (int e = lane; e < k; e += 32) cnt += beats(ls[e], li[e], cs, cn) ? 1 : 0;
    const int pos = __reduce_add_sync(FULL, cnt);
    float vs[KSLOTS];
    int vi[KSLOTS];
#pragma unroll
    for (int u = 0; u < KSLOTS; ++u) {
        const int e = lane + 32 * u;
        if (e < k && e > pos) { vs[u] = ls[e - 1]; vi[u] = li[e - 1]; }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < KSLOTS; ++u) {
        const int e = lane + 32 * u;
        if (e < k && e > pos) { ls[e] = vs[u]; li[e] = vi[u]; }
    }
    if (lane == 0) { ls[pos] = cs; li[pos] = cn; }
    __syncwarp();
}

// One pipeline stage: the QB x DK query chunk and the NB x DK corpus chunk,
// stored as planes of 16-wide feature slices ([DK/16][rows][16]) so that
// every 16x16 WMMA fragment is 32-byte aligned and contiguous.
template <typename T>
__device__ __forceinline__ void load_stage(T* sA, T* sB, const T* __restrict__ q, const T* __restrict__ c,
                                           int B, int D, int q0, int n0, int n_end, int d0, int tid) {
    constexpr int VE = 16 / sizeof(T);  // elements per 16-byte vector
#pragma unroll
    for (int it = 0; it < QB * VECS / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int row = idx / VECS, v = idx % VECS;
        const int col = d0 + v * VE;
        const bool ok = (q0 + row < B) && (col < D);
        const T* src = ok ? q + (size_t)(q0 + row) * D + col : q;
        T* dst = sA + ((v * VE) / 16) * (QB * 16) + row * 16 + (v * VE) % 16;
        cp_async16(dst, src, ok);
    }
#pragma unroll
    for (int it = 0; it < NB * VECS / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int row = idx / VECS, v = idx % VECS;
        const int col = d0 + v * VE;
        const bool ok = (n0 + row < n_end) && (col < D);
        const T* src = ok ? c + (size_t)(n0 + row) * D + col : c;
        T* dst = sB + ((v * VE) / 16) * (NB * 16) + row * 16 + (v * VE) % 16;
        cp_async16(dst, src, ok);
    }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS)
topk_scan_kernel(const T* __restrict__ q, const T* __restrict__ c, const float* __restrict__ scales,
                 int B, int D, int valid_n, int k, int rows_per_split, int splits,
                 float* __restrict__ cand_s, int* __restrict__ cand_i) {
    using AccT = typename Acc<T>::type;
    constexpr int DK = CHUNK_BYTES / sizeof(T);
    constexpr int STAGE_A = QB * DK;  // elements
    constexpr int STAGE_B = NB * DK;

    extern __shared__ __align__(128) unsigned char smem[];
    T* stage = reinterpret_cast<T*>(smem);                              // STAGES x (A, B)
    AccT* sAcc = reinterpret_cast<AccT*>(smem + STAGES * (STAGE_A + STAGE_B) * sizeof(T));
    float* sScale = reinterpret_cast<float*>(sAcc + QB * LDS);
    float* sLs = sScale + NB;
    int* sLi = reinterpret_cast<int*>(sLs + QB * k);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * QB;
    const int split = blockIdx.y;
    const int n_begin = split * rows_per_split;
    const int n_end = min(n_begin + rows_per_split, valid_n);
    const int ntiles = n_end > n_begin ? (n_end - n_begin + NB - 1) / NB : 0;
    const int nchunks = (D + DK - 1) / DK;
    const int total = ntiles * nchunks;

    for (int e = tid; e < QB * k; e += THREADS) { sLs[e] = -INFINITY; sLi[e] = INT_MAX; }

    const int wm = warp % WARPS_M, wn = warp / WARPS_M;  // warp tile: FM*16 query rows x FN*16 corpus rows
    wmma::fragment<wmma::accumulator, 16, 16, 16, AccT> acc[FM][FN];

    // step s = (tile s / nchunks, feature chunk s % nchunks) lives in ring slot s % STAGES
    auto prefetch = [&](int s) {
        if (s < total) {
            T* buf = stage + (s % STAGES) * (STAGE_A + STAGE_B);
            load_stage<T>(buf, buf + STAGE_A, q, c, B, D, q0, n_begin + (s / nchunks) * NB, n_end,
                          (s % nchunks) * DK, tid);
        }
        cp_async_commit();  // possibly empty: keeps one group per step
    };
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) prefetch(p);
    for (int s = 0; s < total; ++s) {
        const int tile = s / nchunks, ch = s % nchunks;
        cp_async_wait<STAGES - 2>();  // step s has landed
        __syncthreads();              // ... for every thread, and slot (s - 1) % STAGES is free
        prefetch(s + STAGES - 1);
        if (ch == 0) {
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], AccT(0));
        }
        const T* sA = stage + (s % STAGES) * (STAGE_A + STAGE_B);
        const T* sB = sA + STAGE_A;
#pragma unroll
        for (int ks = 0; ks < DK / 16; ++ks) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[FM];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b[FN];
#pragma unroll
            for (int i = 0; i < FM; ++i)
                wmma::load_matrix_sync(a[i], sA + ks * (QB * 16) + (wm * FM + i) * 16 * 16, 16);
#pragma unroll
            for (int j = 0; j < FN; ++j)
                wmma::load_matrix_sync(b[j], sB + ks * (NB * 16) + (wn * FN + j) * 16 * 16, 16);
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        if (ch != nchunks - 1) continue;

        // ---- tile epilogue: scores to shared memory, then selection ----
        const int n0 = n_begin + tile * NB;
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j)
                wmma::store_matrix_sync(sAcc + ((wm * FM + i) * 16) * LDS + (wn * FN + j) * 16, acc[i][j], LDS,
                                        wmma::mem_row_major);
        if (EPI == EPI_ROW_SCALE && tid < NB) sScale[tid] = (n0 + tid < n_end) ? scales[n0 + tid] : 0.f;
        __syncthreads();
        for (int r = warp; r < QB && q0 + r < B; r += WARPS) {
            float* ls = sLs + r * k;
            int* li = sLi + r * k;
            float sc[NB / 32];
            bool any = false;
#pragma unroll
            for (int j = 0; j < NB / 32; ++j) {
                const int col = j * 32 + lane;
                if (EPI == EPI_ROW_SCALE) sc[j] = (float)sAcc[r * LDS + col] * sScale[col];
                else sc[j] = (float)sAcc[r * LDS + col];  // int32 -> f32 exact: |raw| < 2^24 for D <= 1024
                any |= (n0 + col < n_end) && beats(sc[j], n0 + col, ls[k - 1], li[k - 1]);
            }
            if (!__any_sync(FULL, any)) continue;  // the common case once the lists have filled
#pragma unroll
            for (int j = 0; j < NB / 32; ++j) {
                const int n = n0 + j * 32 + lane;
                const bool ok = (n < n_end) && beats(sc[j], n, ls[k - 1], li[k - 1]);
                unsigned m = __ballot_sync(FULL, ok);
                while (m) {
                    const int src = __ffs(m) - 1;
                    m &= m - 1;
                    const float cs = __shfl_sync(FULL, sc[j], src);
                    list_insert(ls, li, k, cs, n0 + j * 32 + src, lane);
                }
            }
        }
        // the next write of sAcc/sScale is a full tile away, behind the loop-top barriers
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int r = warp; r < QB; r += WARPS) {
        if (q0 + r >= B) continue;
        const size_t base = ((size_t)(q0 + r) * splits + split) * k;
        for (int e = lane; e < k; e += 32) {
            cand_s[base + e] = sLs[r * k + e];
            cand_i[base + e] = sLi[r * k + e];
        }
    }
}

// Final k per query from its (splits * k) candidates: k rounds, each a
// block-wide argmax over the candidates ranked after the previous pick.
__global__ void __launch_bounds__(256)
topk_merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i, int m, int k,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
    __shared__ float red_s[8];
    __shared__ int red_i[8];
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* cs = cand_s + (size_t)b * m;
    const int* ci = cand_i + (size_t)b * m;
    float prev_s = INFINITY;
    int prev_i = -1;
    for (int r = 0; r < k; ++r) {
        float bs = -INFINITY;
        int bi = INT_MAX;
        for (int e = tid; e < m; e += blockDim.x) {
            const float s = cs[e];
            const int i = ci[e];
            if (beats(prev_s, prev_i, s, i) && beats(s, i, bs, bi)) { bs = s; bi = i; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float os = __shfl_xor_sync(FULL, bs, off);
            const int oi = __shfl_xor_sync(FULL, bi, off);
            if (beats(os, oi, bs, bi)) { bs = os; bi = oi; }
        }
        if (lane == 0) { red_s[warp] = bs; red_i[warp] = bi; }
        __syncthreads();
        bs = red_s[0];
        bi = red_i[0];
        for (int w = 1; w < (int)(blockDim.x / 32); ++w)
            if (beats(red_s[w], red_i[w], bs, bi)) { bs = red_s[w]; bi = red_i[w]; }
        __syncthreads();
        if (tid == 0) {
            out_s[(size_t)b * k + r] = bs;
            out_i[(size_t)b * k + r] = bi == INT_MAX ? -1 : bi;
        }
        prev_s = bs;
        prev_i = bi;
    }
}

template <typename T, int EPI>
int launch_topk(const void* q, const void* c, const float* scales, int B, int D, int valid_n, int k,
                int splits, float* cand_s, int* cand_i, float* out_s, int* out_i, cudaStream_t stream) {
    const int ntiles = (valid_n + NB - 1) / NB;
    const int rows_per_split = ((ntiles + splits - 1) / splits) * NB;
    const size_t smem = STAGES * (size_t)(QB + NB) * CHUNK_BYTES + (size_t)QB * LDS * 4 + NB * 4 + (size_t)QB * k * 8;
    auto kern = topk_scan_kernel<T, EPI>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + QB - 1) / QB, splits);
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(c), scales, B, D,
                                          valid_n, k, rows_per_split, splits, cand_s, cand_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    topk_merge_kernel<<<B, 256, 0, stream>>>(cand_s, cand_i, splits * k, k, out_s, out_i);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 = bf16 corpus (K1), 1 = int8 + per-row scales (K2), 2 = int8 raw (K3).
// cand_s / cand_i hold B * splits * k entries of scratch.
int vqa_matmul_topk(int kind, const void* q, const void* c, const void* scales, int B, int D, int valid_n,
                    int k, int splits, void* cand_s, void* cand_i, void* out_s, void* out_i, void* stream) {
    if (k < 1 || k > MAX_K || valid_n < 1 || splits < 1 || D < 16 || D % 16 != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* cs = static_cast<float*>(cand_s);
    int* ci = static_cast<int*>(cand_i);
    float* os = static_cast<float*>(out_s);
    int* oi = static_cast<int*>(out_i);
    const float* sc = static_cast<const float*>(scales);
    switch (kind) {
        case 0: return launch_topk<__nv_bfloat16, EPI_F32>(q, c, sc, B, D, valid_n, k, splits, cs, ci, os, oi, st);
        case 1: return launch_topk<signed char, EPI_ROW_SCALE>(q, c, sc, B, D, valid_n, k, splits, cs, ci, os, oi, st);
        case 2: return launch_topk<signed char, EPI_RAW>(q, c, sc, B, D, valid_n, k, splits, cs, ci, os, oi, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
