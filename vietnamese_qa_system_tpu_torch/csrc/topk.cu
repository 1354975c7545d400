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
// card's bf16 ridge (~295 op/byte), so both the tensor cores and HBM matter
// (0.41 ms of products at the bf16 peak, 0.47 ms of bytes).  Selection is
// cheap by comparison once a per-query threshold filters the scores: on
// random data only ~k*ln(N/k) scores per query ever enter a list.
//
// Two designs live here.
//
// The cluster scan (K1, topk_cluster_kernel; ops/topk.py bf16_route picks
// it when its shared memory fits: D % 64 == 0, k <= 64, at least 4 ring
// stages -- k <= 60 at D 768):
// - A cluster of C = 1, 2 or 4 CTAs (the power of two that holds the
//   batch's 64-query tiles, at most 256 queries; more queries are more
//   groups in grid y) splits the query axis: each CTA loads its 64 queries
//   once by TMA into swizzled 64-column panels (96 KB at D 768) and keeps
//   them for the whole scan.
// - The grid is persistent: as many clusters as fit the card at once
//   (cudaOccupancyMaxActiveClusters), each scanning a contiguous range of
//   128-row corpus tiles.  A tile comes as D / 64 panels of 128 x 64 bf16
//   (16 KB) through a ring of 4-8 stages (as many as the shared memory
//   left holds) guarded by mbarriers; each CTA's producer warp loads 1/C
//   of every panel with a TMA multicast to all C CTAs, so each corpus byte
//   leaves L2 once per cluster.  A stage is free again only when the
//   consumers of every CTA have read it: its "empty" barrier counts C
//   remote arrivals.  The corpus map's row extent is valid_n: TMA fills
//   rows past it with zeros and the selection masks them.
// - Two consumer warpgroups take alternate tiles: S = Q C^T (64 x 128,
//   f32) by wgmma from the swizzled panels, accumulated in registers, so
//   one warpgroup's selection overlaps the other's products.  A stage goes
//   back as soon as its products are done: a 4-CTA cluster keeps one
//   ring's bytes in flight, so its stream is latency-bound, and a landed
//   stage that waits for its consumer is lost throughput.
// - Selection reads registers: each thread takes the max of its 32
//   accumulator entries of each of its two query rows; only a row whose max
//   reaches the k-th score of its list compares its entries with the k-th
//   (score, index); winners (rare once the lists fill) go through a per-warp queue
//   in shared memory into the row's sorted list, and the queue repeats
//   until no winner is left (the first tiles fill the lists).  Each warp
//   owns 16 query rows of its warpgroup's lists, so no warp waits for
//   another.  No score tile is written to shared memory.
// - The per-(cluster, warpgroup) lists go through topk_merge_kernel.
//
// The tile scan (K2, K3, and K1 where the cluster scan does not fit:
// topk_scan_kernel, the first design of this file):
// - Grid (query tiles of QB=64, corpus splits).  Each block streams its
//   corpus range in NB=128-row tiles; the 64x128 score tile is a WMMA
//   (bf16 -> f32 or int8 -> int32) product accumulated over the feature
//   dimension in 128-byte chunks through a 2-slot cp.async ring.  Each
//   query tile re-reads the corpus from L2 (~2.45 TB/s of operand bytes
//   into shared memory bound it on the H100).
// - Every mode is exact: each block keeps a sorted per-query top-k list in
//   shared memory ordered by (score desc, index asc); one warp per query
//   row ballots the scores that beat the row's k-th entry and inserts them.
// - Blocks write (B, splits, k) candidates; topk_merge_kernel picks the
//   final k per query with k rounds of a block-wide argmax.
// - Rows >= valid_n are never read: splits cover [0, valid_n) only.
// The TPU's lane-bucket selection (topk.py:93-330) is not carried over.
// The query quantisation (int8) and the final per-query scaling stay in
// the Python wrapper, as they do in the JAX package.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <climits>
#include <math.h>
#include <string.h>

#include "hopper.cuh"

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

// Insert (cs, cn) into the sorted list (ls, li) of length k <= 4 * SLOTS
// if it ranks before the last entry, by the 4 lanes of a quad (entry e is
// lane e % 4's); every lane of the warp calls it (the 8 quads each insert
// into their own list, or do nothing where `act` is false).  The quad's
// arguments are uniform.
template <int SLOTS>
__device__ __forceinline__ void quad_insert(float* ls, int* li, int k, float cs, int cn, bool act, int lane) {
    const int q = lane & 3;
    const bool go = act && beats(cs, cn, ls[k - 1], li[k - 1]);
    int pos = 0;
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
        const int e = q + 4 * u;
        if (go && e < k) pos += beats(ls[e], li[e], cs, cn) ? 1 : 0;
    }
    pos += __shfl_xor_sync(FULL, pos, 1);
    pos += __shfl_xor_sync(FULL, pos, 2);
    float vs[SLOTS];
    int vi[SLOTS];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
        const int e = q + 4 * u;
        if (go && e < k && e > pos) { vs[u] = ls[e - 1]; vi[u] = li[e - 1]; }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
        const int e = q + 4 * u;
        if (go && e < k && e > pos) { ls[e] = vs[u]; li[e] = vi[u]; }
    }
    if (go && q == (pos & 3)) { ls[pos] = cs; li[pos] = cn; }
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


// ---- the cluster scan (K1) ---------------------------------------------------

namespace clus {

constexpr int QROWS = 64;                           // queries a CTA: one wgmma M
constexpr int GROUP_Q = 256;                        // queries a cluster of at most 4 CTAs
constexpr int TILE = 128;                           // corpus rows a tile: the wgmma N
constexpr int PANEL = 64;                           // feature columns a stage: one 128-byte swizzle panel
constexpr uint32_t STAGE_BYTES = TILE * PANEL * 2;  // 16 KB
constexpr uint32_t QPANEL_BYTES = QROWS * PANEL * 2;
constexpr int MIN_STAGES = 4, MAX_STAGES = 8;
constexpr int CONSUMERS = 256;                      // two warpgroups
constexpr int THREADS = CONSUMERS + 32;             // and a producer warp
constexpr int CWARPS = CONSUMERS / 32;
constexpr int QW = 64;                              // winner queue entries a consumer warp
constexpr int QQ = QW / 8;                          // ... a quad
constexpr int MAX_K = 64;
constexpr long long SMEM_LIMIT = 232448;            // an H100 block's shared memory

// Shared memory: Q panels | ring | lists (2 warpgroups x 64 rows x k, f32
// scores then int32 ids) | queues (8 warps x QW scores, ids, rows) |
// mbarriers (Q, 2 x MAX_STAGES full: one set a warpgroup, MAX_STAGES
// empty).  ops/topk.py cluster_stages mirrors these numbers.
__host__ __device__ constexpr long long fixed_bytes(int k, int d) {
    return 128LL * d + 1024LL * k + CWARPS * QW * 12 + 8 * (1 + 3 * MAX_STAGES);
}
__host__ __device__ inline int stages_for(int k, int d) {
    const long long s = (SMEM_LIMIT - fixed_bytes(k, d)) / STAGE_BYTES;
    return s > MAX_STAGES ? MAX_STAGES : (int)s;
}

// KQ: list entries a lane of a quad holds, k <= 4 KQ
template <int KQ>
__global__ void __launch_bounds__(THREADS, 1)
topk_cluster_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_c, int B, int D,
                    int valid_n, int k, int stages, float* __restrict__ cand_s, int* __restrict__ cand_i) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = hopper::aligned_smem(smem_raw);
    const int P = D / PANEL, S = stages;
    unsigned char* sQ = smem;
    unsigned char* ring = smem + 128 * D;
    float* ls = reinterpret_cast<float*>(ring + S * STAGE_BYTES);
    int* li = reinterpret_cast<int*>(ls + 2 * QROWS * k);
    float* qs = reinterpret_cast<float*>(li + 2 * QROWS * k);
    int* qi = reinterpret_cast<int*>(qs + CWARPS * QW);
    int* qr = qi + CWARPS * QW;
    uint64_t* q_full = reinterpret_cast<uint64_t*>(qr + CWARPS * QW);
    // a stage's loads for warpgroup w's tiles complete on full[w * MAX_STAGES
    // + s]: the two warpgroups take alternate tiles, so one barrier would
    // let a warpgroup wait on a phase two ahead of the barrier's, which its
    // parity cannot tell from the one before
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + 2 * MAX_STAGES;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const uint32_t C = hopper::cluster_ctas(), rank = hopper::cluster_rank();
    const int clusters = gridDim.x / C, cl = blockIdx.x / C;
    const int q0 = blockIdx.y * GROUP_Q + rank * QROWS;
    const bool active = q0 < B;  // a CTA past the batch only helps load the corpus
    const int tiles = hopper::cdiv(valid_n, TILE);
    const int t0 = (int)((long long)cl * tiles / clusters);
    const int ntiles = (int)((long long)(cl + 1) * tiles / clusters) - t0, total = ntiles * P;
    const int wg = warp / 4;
    float* wls = ls + wg * QROWS * k;  // this warpgroup's lists
    int* wli = li + wg * QROWS * k;
    const volatile float* ols = ls + (wg ^ 1) * QROWS * k;  // the other warpgroup's scores

    if (tid == 0) {
        hopper::mbar_init(q_full, 1);
        for (int s = 0; s < S; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&full[MAX_STAGES + s], 1);
            hopper::mbar_init(&empty[s], C);
        }
        hopper::mbar_fence_init();
    }
    if (warp < CWARPS) {  // each warp's 16 rows of its warpgroup's lists
        for (int e = lane; e < 16 * k; e += 32) {
            wls[(warp & 3) * 16 * k + e] = -INFINITY;
            wli[(warp & 3) * 16 * k + e] = INT_MAX;
        }
    }
    hopper::cluster_sync();  // the peers' barriers exist before any multicast

    if (warp == CWARPS) {  // the producer warp: one thread issues every load
        if (lane == 0) {
            if (active) {
                hopper::mbar_expect_tx(q_full, P * QPANEL_BYTES);
                for (int p = 0; p < P; ++p) hopper::tma_load_3d(sQ + p * QPANEL_BYTES, &tm_q, q_full, p * PANEL, q0, 0);
            }
            const int rows = TILE / C;  // this CTA's share of every panel
            const uint16_t mask = (uint16_t)((1u << C) - 1);
            for (int n = 0; n < total; ++n) {
                const int s = n % S, t = t0 + n / P, p = n % P;
                uint64_t* bar = &full[((n / P) & 1) * MAX_STAGES + s];  // the consuming warpgroup's
                if (n >= S) hopper::mbar_wait(&empty[s], (n / S + 1) & 1);
                hopper::mbar_expect_tx(bar, STAGE_BYTES);  // all C shares land here
                unsigned char* dst = ring + s * STAGE_BYTES + rank * rows * 128;
                if (C == 1) hopper::tma_load_3d(dst, &tm_c, bar, p * PANEL, t * TILE, 0);
                else hopper::tma_load_3d_multicast(dst, &tm_c, bar, p * PANEL, t * TILE + rank * rows, 0, mask);
            }
        }
        __syncwarp();
    } else {
        const int wq = warp, row_a = (warp & 3) * 16 + (lane >> 2);  // this thread's rows: row_a, row_a + 8
        // the stage of ring use n is read: every CTA's producer may refill it
        auto release = [&](int n) {
            hopper::wg_wait<0>();
            hopper::wg_barrier(1 + wg);
            if ((tid & 127) == 0) {
                if (C == 1) hopper::mbar_arrive(&empty[n % S]);
                else
                    for (uint32_t r = 0; r < C; ++r) hopper::mbar_arrive_remote(&empty[n % S], r);
            }
        };
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        uint32_t phases = 0;  // bit s: the parity of this warpgroup's next wait on stage s

        // The selection of a tile: element 4j + 2i + u of its scores is (row
        // row_a + 8i, column sel_cb + 8j + u); mask0 / mask1 mark rows
        // row_a / row_a + 8's candidates not yet queued.
        int sel_cb = 0;
        uint32_t mask0 = 0u, mask1 = 0u;
        bool pending = false;  // warp-uniform

        // A row whose 32 scores here all fall below its k-th score has no
        // winner: the max settles most rows once the lists fill.  A score
        // below the other warpgroup's k-th score of the row cannot place
        // either: that list holds k other rows at or above it (its k-th
        // score only rises, so a read during an insertion is safe).  The
        // masks take every score at or above both (one compare a score; the
        // exact rule, ties to the lower index, is the insertion's, which
        // rejects the rest); rows past valid_n exist only in the last tile.
        auto sel_start = [&](const float (&a)[64], int tile) {
            sel_cb = (t0 + tile) * TILE + 2 * (lane & 3);
            float t[2];
            bool hit[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                t[i] = fmaxf(wls[(row_a + 8 * i) * k + k - 1], ols[(row_a + 8 * i) * k + k - 1]);
                float mx = a[2 * i];
#pragma unroll
                for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(a[4 * j + 2 * i], a[4 * j + 2 * i + 1]));
                hit[i] = q0 + row_a + 8 * i < B && mx >= t[i];
            }
            mask0 = mask1 = 0u;
            pending = __any_sync(FULL, hit[0] || hit[1]);
            if (!pending) return;
            uint32_t valid = ~0u;
            if (sel_cb - 2 * (lane & 3) + TILE > valid_n) {
                valid = 0u;
#pragma unroll
                for (int b = 0; b < 32; ++b) valid |= (uint32_t)(sel_cb + 8 * (b >> 1) + (b & 1) < valid_n) << b;
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                uint32_t m = 0u;
                if (hit[i])
#pragma unroll
                    for (int b = 0; b < 32; ++b) m |= (uint32_t)(a[4 * (b >> 1) + 2 * i + (b & 1)] >= t[i]) << b;
                (i == 0 ? mask0 : mask1) = m & valid;
            }
            pending = __any_sync(FULL, (mask0 | mask1) != 0u);
        };
        // One round: the candidates into the quad's part of the warp's queue
        // in lane order (positions from a prefix sum of the quad's lanes'
        // counts; those past its end wait a round), the 8 quads' insertions
        // side by side, and, if some wait, the masks cut to the risen
        // thresholds.
        auto sel_round = [&](const float (&a)[64]) {
            const int mine = __popc(mask0) + __popc(mask1);
            int pos = mine;
#pragma unroll
            for (int d = 1; d < 4; d <<= 1) {
                const int v = __shfl_up_sync(FULL, pos, d, 4);
                if ((lane & 3) >= d) pos += v;
            }
            const int cnt = min(__shfl_sync(FULL, pos, 3, 4), QQ);
            pos -= mine;
            const int qbase = wq * QW + (lane >> 2) * QQ;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                uint32_t& m = i == 0 ? mask0 : mask1;
                if (m != 0u && pos < QQ) {
#pragma unroll
                    for (int bt = 0; bt < 32; ++bt)
                        if ((m & (1u << bt)) && pos < QQ) {
                            qs[qbase + pos] = a[4 * (bt >> 1) + 2 * i + (bt & 1)];
                            qi[qbase + pos] = sel_cb + 8 * (bt >> 1) + (bt & 1);
                            qr[qbase + pos] = row_a + 8 * i;
                            m &= ~(1u << bt);
                            ++pos;
                        }
                }
            }
            __syncwarp();
            const int rounds = __reduce_max_sync(FULL, cnt);
            for (int e = 0; e < rounds; ++e) {
                const bool act = e < cnt;
                const int r = act ? qr[qbase + e] : row_a;
                quad_insert<KQ>(wls + r * k, wli + r * k, k, act ? qs[qbase + e] : 0.f, act ? qi[qbase + e] : 0, act,
                                lane);
            }
            pending = __any_sync(FULL, (mask0 | mask1) != 0u);
            if (!pending) return;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float t = fmaxf(wls[(row_a + 8 * i) * k + k - 1], ols[(row_a + 8 * i) * k + k - 1]);
                uint32_t keep = 0u;
#pragma unroll
                for (int bt = 0; bt < 32; ++bt) keep |= (uint32_t)(a[4 * (bt >> 1) + 2 * i + (bt & 1)] >= t) << bt;
                (i == 0 ? mask0 : mask1) &= keep;
            }
            pending = __any_sync(FULL, (mask0 | mask1) != 0u);
        };
        if (active) hopper::mbar_wait(q_full, 0);
        for (int lt = wg; lt < ntiles; lt += 2) {
            // Each stage goes back as soon as its products are done, before the
            // wait for the next: the ring, not the tensor cores, bounds the scan
            // (a 4-CTA cluster has one ring's bytes in flight), so a stage held
            // until the next one lands would cost a ring slot.
            for (int p = 0; p < P; ++p) {
                const int n = lt * P + p, s = n % S;
                if (p > 0) release(n - 1);
                hopper::mbar_wait(&full[wg * MAX_STAGES + s], (phases >> s) & 1);
                phases ^= 1u << s;
                // every CTA runs the products, an inactive one's on unread
                // query memory: a wgmma behind a branch is serialized by ptxas
                const unsigned char* st = ring + s * STAGE_BYTES;
                hopper::wg_fence();
#pragma unroll
                for (int kq = 0; kq < 4; ++kq)
                    hopper::wgmma_ss_n128(acc, hopper::desc_k<PANEL, 128>(sQ, QROWS, 0, 4 * p + kq),
                                          hopper::desc_k<PANEL, 128>(st, TILE, 0, kq), (p | kq) != 0);
                hopper::wg_commit();
            }
            release(lt * P + P - 1);
            hopper::fence_regs(acc);
            if (!active) continue;
            sel_start(acc, lt);
            while (pending) sel_round(acc);
        }
        // this warp's rows of its warpgroup's lists -> candidates (query, cl * 2 + wg, k)
        const int splits = 2 * clusters;
        for (int r = 0; r < 16; ++r) {
            const int row = (warp & 3) * 16 + r;
            if (!active || q0 + row >= B) break;
            const size_t base = ((size_t)(q0 + row) * splits + cl * 2 + wg) * k;
            for (int e = lane; e < k; e += 32) {
                cand_s[base + e] = wls[row * k + e];
                cand_i[base + e] = wli[row * k + e];
            }
        }
    }
    hopper::cluster_sync();  // no CTA leaves while a peer may still write to it
}

inline cudaLaunchConfig_t launch_config(int C, int grid_x, int grid_y, uint32_t smem, cudaStream_t st,
                                        cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg;
    memset(&cfg, 0, sizeof(cfg));
    cfg.gridDim = dim3(grid_x, grid_y);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// the kernel's form for k: list entries a lane of a quad holds
inline const void* kernel_for(int k) {
    return k <= 16 ? (const void*)topk_cluster_kernel<4> : (const void*)topk_cluster_kernel<MAX_K / 4>;
}

inline bool shape_ok(int C, int k, int D) {
    return (C == 1 || C == 2 || C == 4) && D >= PANEL && D % PANEL == 0 && k >= 1 && k <= MAX_K &&
           stages_for(k, D) >= MIN_STAGES;
}

int launch(const void* q, const void* c, int B, int D, int valid_n, int k, int C, int clusters, float* cand_s,
           int* cand_i, float* out_s, int* out_i, cudaStream_t st) {
    if (!shape_ok(C, k, D) || B < 1 || valid_n < k || clusters < 1) return (int)cudaErrorInvalidValue;
    int S = stages_for(k, D);
    const uint32_t smem = (uint32_t)(fixed_bytes(k, D) + (long long)S * STAGE_BYTES);
    CUtensorMap mq, mc;
    if (!hopper::map_bf16_tiles(&mq, q, 1, B, D, QROWS) || !hopper::map_bf16_tiles(&mc, c, 1, valid_n, D, TILE / C))
        return (int)cudaErrorInvalidValue;
    const void* kern = kernel_for(k);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(C, clusters * C, hopper::cdiv(B, GROUP_Q), smem, st, &attr);
    void* args[] = {&mq, &mc, &B, &D, &valid_n, &k, &S, &cand_s, &cand_i};
    err = cudaLaunchKernelExC(&cfg, kern, args);
    if (err != cudaSuccess) return (int)err;
    topk_merge_kernel<<<B, 256, 0, st>>>(cand_s, cand_i, 2 * clusters * k, k, out_s, out_i);
    return (int)cudaGetLastError();
}

}  // namespace clus

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

// K1's cluster scan: bf16 q (B, D) and corpus (>= valid_n, D), 16-byte
// aligned; C CTAs a cluster (1, 2, 4), `clusters` clusters a group of 256
// queries; cand_s / cand_i hold B * 2 * clusters * k entries of scratch.
int vqa_topk_bf16_cluster(const void* q, const void* c, int B, int D, int valid_n, int k, int C, int clusters,
                          void* cand_s, void* cand_i, void* out_s, void* out_i, void* stream) {
    return clus::launch(q, c, B, D, valid_n, k, C, clusters, static_cast<float*>(cand_s), static_cast<int*>(cand_i),
                      static_cast<float*>(out_s), static_cast<int*>(out_i), static_cast<cudaStream_t>(stream));
}

// out[5] = clusters of C CTAs the card holds at once, registers a thread,
// dynamic shared memory, local (spill) bytes a thread, ring stages of the
// form that runs k
int vqa_topk_cluster_info(int C, int k, int D, int* out) {
    if (!clus::shape_ok(C, k, D)) return (int)cudaErrorInvalidValue;
    const int S = clus::stages_for(k, D);
    const uint32_t smem = (uint32_t)(clus::fixed_bytes(k, D) + (long long)S * clus::STAGE_BYTES);
    const void* kern = clus::kernel_for(k);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
    cudaLaunchAttribute cattr;
    cudaLaunchConfig_t cfg = clus::launch_config(C, C, 1, smem, 0, &cattr);
    int n = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    out[0] = n;
    out[1] = attr.numRegs;
    out[2] = (int)smem;
    out[3] = (int)attr.localSizeBytes;
    out[4] = S;
    return 0;
}

}  // extern "C"
