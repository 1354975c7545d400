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
// (0.41 ms of products at the bf16 peak, 0.47 ms of bytes; int8 0.20 ms of
// products, 0.24 ms of bytes: 0.241 ms for K3, which reads no row scales).  Selection is cheap by comparison once a
// per-query threshold filters the scores: on random data only ~k*ln(N/k)
// scores per query ever pass it.
//
// Two scans and one merge live here.  ops/topk.py bf16_route / int8_route /
// int8_global_route pick the scan by a pure rule of (k, D), which
// clus::form_for recomputes.
//
// The cluster scan (K1-K3, topk_cluster_kernel<Elem, KQ>, one template over
// three element forms: Bf16, S8 -- int8 with row scales -- and S8Raw --
// int8 selected on its raw sums):
// - A cluster of C = 1, 2 or 4 CTAs (the power of two that holds the
//   batch's 64-query tiles, at most 256 queries; more queries are more
//   groups in grid y) splits the query axis: each CTA loads its 64 queries
//   once by TMA into swizzled panels of 128-byte rows (64 bf16 or 128 int8
//   columns; 96 KB bf16, 48 KB int8 at D 768) and keeps them for the scan.
// - The grid is persistent: as many clusters as fit the card at once
//   (cudaOccupancyMaxActiveClusters), each scanning a contiguous range of
//   128-row corpus tiles.  A tile comes as panels of 128 rows x 128 bytes
//   (16 KB) through a ring of 4-8 stages (as many as the shared memory
//   left holds) guarded by mbarriers; each CTA's producer warp loads 1/C
//   of every panel with a TMA multicast to all C CTAs, so each corpus byte
//   leaves L2 once per cluster.  A stage is free again only when the
//   consumers of every CTA have read it: its "empty" barrier counts C
//   remote arrivals.  The corpus map's row extent is valid_n: TMA fills
//   rows past it with zeros and the selection masks them.  K2's 128 row
//   scales of a tile (512 B) land by a 1-D TMA on the stage of the tile's
//   last panel; K3's stages hold the panel alone.
// - Two consumer warpgroups take alternate tiles: S = Q C^T (64 x 128) by
//   wgmma from the swizzled panels, accumulated in registers (bf16 -> f32,
//   or s8 -> s32 for K2 and K3), so one warpgroup's selection overlaps the
//   other's products.  K2's epilogue turns a tile's raw sums in place into
//   __int2float_rn(raw) * scale[row] -- the plain version's f32 product,
//   as |raw| < 2^24 at D <= 1024; K3 selects on __int2float_rn(raw),
//   converted where each score is read (a write to the accumulators would
//   serialize the wgmma, and K3 holds no scales that a later read would
//   keep live).  A stage goes back as soon as its
//   products (and scales) are read: a 4-CTA cluster keeps one ring's bytes
//   in flight, so its stream is latency-bound, and a landed stage that
//   waits for its consumer is lost throughput.
// - Selection reads registers: each thread takes the max of its 32 scores
//   of each of its two query rows; only a row whose max reaches its
//   threshold (at least the other warpgroup's k-th score of the row: that
//   list or pool holds k rows at or above it) looks at its entries.  Then
//   one of two forms (KQ):
//   * lists (KQ > 0, k <= 64): a sorted (64, k) list per warpgroup in
//     shared memory; winners go through a per-warp queue and the 8 quads
//     of a warp insert into their own rows side by side, until no winner
//     is left (the first tiles fill the lists).
//   * pools (KQ == 0, k <= 256, where (64, k) lists would not fit beside
//     the queries and the ring): each (warpgroup, query) appends the
//     entries that beat its threshold (the k-th (score, index) it kept)
//     to a pool of CAP = 512 entries in global scratch; when a tile's
//     entries would overflow it, the row's warp keeps the best k by a
//     radix select of their 64-bit keys (merge_key).  Appending every
//     winner of every split (k ln(N / k) a split) cost more than the
//     stream, so each (warpgroup, query) also publishes J running maxima,
//     each over its own tiles -- J distinct rows' scores -- and the k-th
//     largest of a query's 2 x clusters x J published maxima is a floor:
//     k distinct rows reach it, so no score below it places.  Warps read
//     the floors at a warpgroup's 2J-th and 8J-th tile and on overflow;
//     after that few entries reach a pool.
//   Each warp owns 16 query rows of its warpgroup, so no warp waits for
//   another.  No score tile is written to shared memory.
// - Each (cluster, warpgroup) writes its candidates: its k list entries a
//   query (lists), or the best k of its pool at or above the floor,
//   packed per query behind an atomic count (pools).

// The tile scan (K1-K3 where neither cluster form fits, e.g. D % 64 != 0:
// topk_scan_kernel, the first design of this file):
// - Grid (query tiles of QB=64, corpus splits).  Each block streams its
//   corpus range in NB=128-row tiles; the 64x128 score tile is a WMMA
//   (bf16 -> f32 or int8 -> int32) product accumulated over the feature
//   dimension in 128-byte chunks through a 2-slot cp.async ring.  Each
//   query tile re-reads the corpus from L2 (~2.45 TB/s of operand bytes
//   into shared memory bound it on the H100).
// - Each block keeps a sorted per-query top-k list in shared memory; one
//   warp per query row ballots the scores that beat the row's k-th entry
//   and inserts them one at a time.
// - Rows >= valid_n are never read: splits cover [0, valid_n) only.
//
// The merge (topk_merge_kernel, after either scan): one block a query
// finds the k-th smallest 64-bit key (score descending, then index
// ascending; -0.0 ranked as +0.0, as `beats` does) among its m candidates
// (the pool form's count of them)
// by a radix select of 8-bit digits (a histogram a pass, usually 3-4
// passes), keeps the k keys at or below it and ranks them by counting:
// O(m) a query plus O(k^2 / threads), not k rounds over m.
//
// Every form is exact: ties resolve to the lowest index.  The TPU's
// lane-bucket selection (topk.py:93-330) is not carried over.  The query
// quantisation (int8) and the final per-query scaling stay in the Python
// wrapper, as they do in the JAX package.

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

// Element forms, the codes of both entry points' first argument: the
// tile scan's epilogue and the cluster scan's element type.  K1: bf16
// queries and corpus, f32 scores; K2: int8 codes, scores raw * scale[row];
// K3: int8 codes, scores the raw sums (one global scale, applied by the
// caller to the (B, k) output).
enum Elem { EL_BF16 = 0, EL_S8 = 1, EL_S8_RAW = 2 };

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
        if (EPI == EL_S8 && tid < NB) sScale[tid] = (n0 + tid < n_end) ? scales[n0 + tid] : 0.f;
        __syncthreads();
        for (int r = warp; r < QB && q0 + r < B; r += WARPS) {
            float* ls = sLs + r * k;
            int* li = sLi + r * k;
            float sc[NB / 32];
            bool any = false;
#pragma unroll
            for (int j = 0; j < NB / 32; ++j) {
                const int col = j * 32 + lane;
                if (EPI == EL_S8) sc[j] = (float)sAcc[r * LDS + col] * sScale[col];
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

// ---- the merge ---------------------------------------------------------------

constexpr int BINS = 256;             // radix digits of 8 bits
constexpr int MERGE_THREADS = 512;

// The 64-bit merge key of (s, i): the smaller key ranks first, in `beats`'s
// order (higher score, then lower index), with -0.0 ranked as +0.0 (an
// order-preserving bit key would rank +0.0 first).  ops/topk.py merge_key
// mirrors it.
__device__ __forceinline__ uint32_t score_key(float s) {
    uint32_t u = __float_as_uint(s);
    if ((u << 1) == 0u) u = 0u;
    return u ^ ((u >> 31) ? 0u : 0x7fffffffu);
}
__device__ __forceinline__ float key_score(uint32_t h) { return __uint_as_float(h ^ ((h >> 31) ? 0u : 0x7fffffffu)); }
__device__ __forceinline__ uint64_t merge_key(float s, int i) { return ((uint64_t)score_key(s) << 32) | (uint32_t)i; }

// Every lane of the warp: count `digit` (BINS: nothing) in hist, one atomic
// a distinct digit of the warp (the scores of a pass share a few digits).
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned digit, int lane) {
    const unsigned peers = __match_any_sync(FULL, digit);
    if (digit < BINS && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], (unsigned)__popc(peers));
}

// Every lane of one warp: the bin holding the need-th (from 1) smallest key
// counted in hist, the keys in the bins below it and the keys in it.
__device__ __forceinline__ void find_bin(const unsigned* hist, unsigned need, int lane, unsigned& bin,
                                         unsigned& before, unsigned& in) {
    unsigned c[BINS / 32], sum = 0;
#pragma unroll
    for (int j = 0; j < BINS / 32; ++j) { c[j] = hist[(BINS / 32) * lane + j]; sum += c[j]; }
    unsigned incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
    }
    unsigned run = incl - sum, fb = 0, fi = 0;
    int found = -1;
#pragma unroll
    for (int j = 0; j < BINS / 32; ++j) {
        if (found < 0 && run + c[j] >= need) { found = j; fb = run; fi = c[j]; }
        run += c[j];
    }
    const int src = __ffs(__ballot_sync(FULL, found >= 0)) - 1;  // the first lane whose bins reach need
    bin = __shfl_sync(FULL, (BINS / 32) * lane + found, src);
    before = __shfl_sync(FULL, fb, src);
    in = __shfl_sync(FULL, fi, src);
}

// Final k per query from its m candidates (counts[b] of them if `counts`;
// one block a query): a radix
// select of the k-th smallest merge key, 8 bits a pass over the candidates
// still tied with it (it stops once every key of its bin is kept), then
// the keys at or below it, ranked by counting.  Padding (-inf, INT_MAX)
// ranks last and comes out as id -1.
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i, int m,
                  const int* __restrict__ counts, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
    __shared__ unsigned hist[BINS];
    __shared__ unsigned pick[3];
    __shared__ unsigned kept;
    __shared__ uint64_t sel_key[MAX_K];
    __shared__ float sel_s[MAX_K];
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    const int T = blockDim.x;
    const float* cs = cand_s + (size_t)b * m;
    const int* ci = cand_i + (size_t)b * m;
    if (counts != nullptr) m = counts[b];  // the pool form writes its candidates compactly
    uint64_t prefix = 0;
    int shift = 56;
    unsigned need = k;
    for (int pass = 0; pass < 8; ++pass) {
        shift = 56 - 8 * pass;
        for (int t = tid; t < BINS; t += T) hist[t] = 0u;
        __syncthreads();
        for (int e0 = 0; e0 < m; e0 += 4 * T) {  // four loads in flight a thread
            uint64_t key[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int e = e0 + u * T + tid;
                key[u] = e < m ? merge_key(cs[e], ci[e]) : ~0ull;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const bool in = e0 + u * T + tid < m && (pass == 0 || (key[u] >> (shift + 8)) == prefix);
                hist_add(hist, in ? (unsigned)(key[u] >> shift) & (BINS - 1) : BINS, lane);
            }
        }
        __syncthreads();
        if (tid < 32) {
            unsigned bin, before, in;
            find_bin(hist, need, lane, bin, before, in);
            if (lane == 0) { pick[0] = bin; pick[1] = before; pick[2] = in; }
        }
        __syncthreads();
        prefix = (prefix << 8) | pick[0];
        need -= pick[1];
        if (pick[2] == need) break;  // uniform; pick is rewritten only after the next pass's barriers
    }
    if (tid == 0) kept = 0u;
    __syncthreads();
    for (int e = tid; e < m; e += T) {
        const float s = cs[e];
        const uint64_t key = merge_key(s, ci[e]);
        if ((key >> shift) <= prefix) {
            const unsigned p = atomicAdd(&kept, 1u);
            if (p < (unsigned)k) { sel_key[p] = key; sel_s[p] = s; }
        }
    }
    __syncthreads();
    for (int t = tid; t < k; t += T) {
        const uint64_t key = sel_key[t];
        int rank = 0;
        for (int j = 0; j < k; ++j) rank += sel_key[j] < key ? 1 : 0;
        const int i = (int)(uint32_t)key;
        out_s[(size_t)b * k + rank] = sel_s[t];
        out_i[(size_t)b * k + rank] = i == INT_MAX ? -1 : i;
    }
}


// ---- the cluster scan (K1-K3) -------------------------------------------------

namespace clus {

constexpr int QROWS = 64;                               // queries a CTA: one wgmma M
constexpr int GROUP_Q = 256;                            // queries a cluster of at most 4 CTAs
constexpr int TILE = 128;                               // corpus rows a tile: the wgmma N
constexpr int ROW_BYTES = 128;                          // a panel's row: 64 bf16 or 128 int8 columns, one 128-byte swizzle
constexpr uint32_t STAGE_BYTES = TILE * ROW_BYTES;      // 16 KB
constexpr uint32_t QPANEL_BYTES = QROWS * ROW_BYTES;
constexpr uint32_t SCALE_BYTES = TILE * 4;              // K2: a tile's row scales
constexpr int MIN_STAGES = 4, MAX_STAGES = 8;
constexpr int CONSUMERS = 256;                          // two warpgroups
constexpr int THREADS = CONSUMERS + 32;                 // and a producer warp
constexpr int CWARPS = CONSUMERS / 32;
constexpr int QW = 64;                                  // list form: winner queue entries a consumer warp
constexpr int QQ = QW / 8;                              // ... a quad
constexpr int LIST_K = 64;                              // the list form's largest k
constexpr int CAP = 512;                                // pool form: entries a (warpgroup, query) pool, >= MAX_K + TILE
constexpr int PR = CAP / 32;                            // ... a lane holds while it selects
constexpr int MAX_SLOTS = 8;                            // pool form: published maxima a (warpgroup, query)
constexpr long long SMEM_LIMIT = 232448;                // an H100 block's shared memory
enum Form { NONE = 0, LISTS = 1, POOLS = 2 };

// `el` below is an element form (Elem); `bytes` bytes an element
__host__ __device__ constexpr int elem_bytes(int el) { return el == EL_BF16 ? 2 : 1; }
__host__ __device__ constexpr int panels(int d, int bytes) { return (d * bytes + ROW_BYTES - 1) / ROW_BYTES; }
__host__ __device__ constexpr uint32_t stage_bytes(int el) { return STAGE_BYTES + (el == EL_S8 ? SCALE_BYTES : 0); }
__host__ __device__ constexpr long long floor_bytes() { return 2LL * QROWS * (16 + 4 * MAX_SLOTS) + CWARPS * BINS * 4; }
// the pools always; the int8 forms' lists of more than 16 entries
__host__ __device__ constexpr bool has_floors(int k, int form, int el) { return form == POOLS || (el != EL_BF16 && k > 16); }
__host__ __device__ constexpr long long select_bytes(int k, int form, int el) {
    return (form == POOLS ? 0 : 1024LL * k + CWARPS * QW * 12) + (has_floors(k, form, el) ? floor_bytes() : 0);
}

// Shared memory: Q panels | ring | K2's scales (a tile's a stage) | the
// selection's state -- lists: 2 warpgroups x 64 rows x k, f32 scores then
// int32 ids, and queues (8 warps x QW scores, ids, rows), then (K2 and K3
// at k > 16) the floors' state; pools: the floors' state -- the rows' counts, threshold
// scores and ids, floors (2 x 64 each), published maxima (2 x 64 x
// MAX_SLOTS) and a histogram of BINS a warp | mbarriers (Q, 2 x MAX_STAGES full: one set a warpgroup,
// MAX_STAGES empty).  ops/topk.py cluster_stages mirrors these numbers.
__host__ __device__ constexpr long long fixed_bytes(int k, int d, int el, int form) {
    return (long long)QPANEL_BYTES * panels(d, elem_bytes(el)) + select_bytes(k, form, el) + 8 * (1 + 3 * MAX_STAGES);
}
__host__ __device__ inline int stages_for(int k, int d, int el, int form) {
    const long long s = (SMEM_LIMIT - fixed_bytes(k, d, el, form)) / stage_bytes(el);
    return s > MAX_STAGES ? MAX_STAGES : (int)s;
}
inline uint32_t smem_for(int k, int d, int el, int form) {
    return (uint32_t)(fixed_bytes(k, d, el, form) + (long long)stages_for(k, d, el, form) * stage_bytes(el));
}
// The form that runs top-k at width d (ops/topk.py bf16_route / int8_route
// / int8_global_route): lists where they leave MIN_STAGES ring stages, else
// pools where those do, else none (the tile scan).  int8 needs D <= 1024
// (exact f32 scores).
inline int form_for(int k, int d, int el) {
    if (el < EL_BF16 || el > EL_S8_RAW || d < 64 || d % 64 != 0 || k < 1 || k > MAX_K || (el != EL_BF16 && d > 1024))
        return NONE;
    if (k <= LIST_K && stages_for(k, d, el, LISTS) >= MIN_STAGES) return LISTS;
    return stages_for(k, d, el, POOLS) >= MIN_STAGES ? POOLS : NONE;
}

struct Bf16 {
    static constexpr int EL = EL_BF16, ELEM = 2;
    using Acc = float;
    static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
        hopper::wgmma_ss_n128(d, a, b, scale_d);
    }
};
struct S8 {
    static constexpr int EL = EL_S8, ELEM = 1;
    using Acc = uint32_t;  // s32 sums, then (after the epilogue) the f32 scores' bits
    static __device__ __forceinline__ void mma(uint32_t (&d)[64], uint64_t a, uint64_t b, int scale_d) {
        hopper::wgmma_ss_s8_n128(d, a, b, scale_d);
    }
};
// K3: S8's products, no scales; the accumulators keep the s32 sums
struct S8Raw : S8 {
    static constexpr int EL = EL_S8_RAW;
};

// Every lane of the warp: of the n entries at (ss, si) that score at or
// above `floor`, keep the k best (all if at most k; else those whose merge
// key is at or below the k-th's, found by a radix select) and write them in
// no order to (ds, di): from ds[0] (ds may be ss), or, with `gcnt`, from a
// base that an atomic add on *gcnt reserves.  Returns the largest kept key:
// the k-th when k are kept; `kept` is their count.
__device__ __forceinline__ uint64_t keep_best(const float* ss, const int* si, int n, int k, float floor, float* ds,
                                              int* di, int* gcnt, unsigned* hist, int lane, int& kept) {
    float s[PR];
    int id[PR];
    int nv = 0;
#pragma unroll
    for (int u = 0; u < PR; ++u) {
        const int e = lane + 32 * u;
        s[u] = e < n ? ss[e] : -INFINITY;
        id[u] = e < n ? si[e] : INT_MAX;
    }
    auto ok = [&](int u) { return lane + 32 * u < n && s[u] >= floor; };
#pragma unroll
    for (int u = 0; u < PR; ++u) nv += __popc(__ballot_sync(FULL, ok(u)));
    __syncwarp();  // read before any entry is overwritten
    uint64_t prefix = 0;
    int shift = 0;
    if (nv > k) {
        unsigned need = k;
        for (int pass = 0; pass < 8; ++pass) {
            shift = 56 - 8 * pass;
            for (int t = lane; t < BINS; t += 32) hist[t] = 0u;
            __syncwarp();
#pragma unroll
            for (int u = 0; u < PR; ++u) {
                const uint64_t key = merge_key(s[u], id[u]);
                const bool in = ok(u) && (pass == 0 || (key >> (shift + 8)) == prefix);
                hist_add(hist, in ? (unsigned)(key >> shift) & (BINS - 1) : BINS, lane);
            }
            __syncwarp();
            unsigned bin, before, in;
            find_bin(hist, need, lane, bin, before, in);
            __syncwarp();
            prefix = (prefix << 8) | bin;
            need -= before;
            if (in == need) break;
        }
    }
    kept = nv < k ? nv : k;
    int base = 0;
    if (gcnt != nullptr) {
        if (lane == 0) base = atomicAdd(gcnt, kept);
        base = __shfl_sync(FULL, base, 0);
    }
    uint64_t worst = 0;
#pragma unroll
    for (int u = 0; u < PR; ++u) {
        const uint64_t key = merge_key(s[u], id[u]);
        const bool keep = ok(u) && (nv <= k || (key >> shift) <= prefix);
        const unsigned bal = __ballot_sync(FULL, keep);
        if (keep) {
            const int p = base + __popc(bal & ((1u << lane) - 1u));
            ds[p] = s[u];
            di[p] = id[u];
            worst = key > worst ? key : worst;
        }
        base += __popc(bal);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const uint64_t o = __shfl_xor_sync(FULL, worst, off);
        worst = o > worst ? o : worst;
    }
    __syncwarp();
    return worst;
}

// Every lane of the warp: the k-th largest of the n <= CAP published keys
// at `keys` (0, below every key, when n < k), by a radix select of their
// complements, read past L1 (other CTAs write them).  HOLD: read once into
// registers; else read again each pass (volatile), which frees registers
// that K2's lists need (held there, they spilled) and costs the pools time.
template <bool HOLD>
__device__ __forceinline__ uint32_t kth_largest(const uint32_t* keys, int n, int k, unsigned* hist, int lane) {
    if (n < k) return 0u;
    const volatile uint32_t* vk = keys;
    uint32_t held[HOLD ? PR : 1];
    if constexpr (HOLD)
#pragma unroll
        for (int u = 0; u < PR; ++u) held[u] = lane + 32 * u < n ? ~vk[lane + 32 * u] : ~0u;
    uint32_t prefix = 0;
    unsigned need = k;
    for (int pass = 0; pass < 4; ++pass) {
        const int shift = 24 - 8 * pass;
        for (int t = lane; t < BINS; t += 32) hist[t] = 0u;
        __syncwarp();
#pragma unroll
        for (int u = 0; u < PR; ++u) {  // a warp-uniform trip count: hist_add takes every lane
            const int e = lane + 32 * u;
            uint32_t v;
            if constexpr (HOLD) v = held[u];
            else v = e < n ? ~vk[e] : ~0u;
            const bool in = e < n && (pass == 0 || (v >> (shift + 8)) == prefix);
            hist_add(hist, in ? (v >> shift) & (BINS - 1) : BINS, lane);
        }
        __syncwarp();
        unsigned bin, before, in;
        find_bin(hist, need, lane, bin, before, in);
        __syncwarp();
        prefix = (prefix << 8) | bin;
        need -= before;
    }
    return ~prefix;
}

// E: the element type (Bf16: K1; S8: K2, scores raw * scale[row]; S8Raw:
// K3, scores raw).
// KQ > 0: the list form, k <= 4 KQ list entries a lane of a quad holds;
// KQ == 0: the pool form: pool_s / pool_i hold B x 2 clusters x CAP
// entries, glob (zeroed) B x CAP published keys and then B candidate counts.
template <typename E, int KQ>
__global__ void __launch_bounds__(THREADS, 1)
topk_cluster_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_s, int B, int D, int valid_n, int k, int stages,
                    float* __restrict__ pool_s, int* __restrict__ pool_i, uint32_t* __restrict__ glob,
                    float* __restrict__ cand_s, int* __restrict__ cand_i) {
    constexpr bool SCALED = E::EL == EL_S8;
    // K3 converts its s32 sums where each score is read; K2 in place, by
    // its epilogue (see there)
    constexpr bool RAW_AT_READ = E::EL == EL_S8_RAW;
    constexpr int FORM = KQ > 0 ? LISTS : POOLS;
    // the int8 lists of more than 16 entries take a floor too (at k <= 16
    // it measured slower for K2; bf16's k <= 60 lists have no room for it)
    constexpr bool FLOORS = FORM == POOLS || (E::ELEM == 1 && KQ > 4);
    constexpr int COLS = ROW_BYTES / E::ELEM;  // feature columns a panel
    using Acc = typename E::Acc;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = hopper::aligned_smem(smem_raw);
    const int P = panels(D, E::ELEM), S = stages;
    unsigned char* sQ = smem;
    unsigned char* ring = smem + P * QPANEL_BYTES;
    float* scl = reinterpret_cast<float*>(ring + S * STAGE_BYTES);  // K2: stage s's scales at s * TILE
    unsigned char* sel = ring + S * stage_bytes(E::EL);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(sel + select_bytes(k, FORM, E::EL));
    // a stage's loads for warpgroup w's tiles complete on full[w * MAX_STAGES
    // + s]: the two warpgroups take alternate tiles, so one barrier would
    // let a warpgroup wait on a phase two ahead of the barrier's, which its
    // parity cannot tell from the one before
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + 2 * MAX_STAGES;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const uint32_t C = hopper::cluster_ctas(), rank = hopper::cluster_rank();
    const int clusters = gridDim.x / C, cl = blockIdx.x / C;
    const int splits = 2 * clusters;
    const int q0 = blockIdx.y * GROUP_Q + rank * QROWS;
    const bool active = q0 < B;  // a CTA past the batch only helps load the corpus
    const int tiles = hopper::cdiv(valid_n, TILE);
    const int t0 = (int)((long long)cl * tiles / clusters);
    const int ntiles = (int)((long long)(cl + 1) * tiles / clusters) - t0, total = ntiles * P;
    const int wg = warp / 4;
    // list form: this warpgroup's lists, the other's scores
    float* wls = reinterpret_cast<float*>(sel) + wg * QROWS * k;
    int* wli = reinterpret_cast<int*>(sel + 512 * k) + wg * QROWS * k;
    const volatile float* ols = reinterpret_cast<float*>(sel) + (wg ^ 1) * QROWS * k;
    float* qs = reinterpret_cast<float*>(sel + 1024 * k);
    int* qi = reinterpret_cast<int*>(qs + CWARPS * QW);
    int* qr = qi + CWARPS * QW;
    // pool form: this warpgroup's rows' counts, thresholds and published
    // maxima, the rows' floors (the CTA's), the other warpgroup's threshold
    // scores, this warp's histogram; K2's list form keeps the floors' part
    // behind its queues
    unsigned char* fsel = FORM == POOLS ? sel : sel + 1024 * k + CWARPS * QW * 12;
    int* wcnt = reinterpret_cast<int*>(fsel) + wg * QROWS;
    float* wts = reinterpret_cast<float*>(fsel + 4 * 2 * QROWS) + wg * QROWS;
    int* wti = reinterpret_cast<int*>(fsel + 8 * 2 * QROWS) + wg * QROWS;
    volatile float* cfl = reinterpret_cast<float*>(fsel + 12 * 2 * QROWS);
    uint32_t* wpm = reinterpret_cast<uint32_t*>(fsel + 16 * 2 * QROWS) + wg * QROWS * MAX_SLOTS;
    const volatile float* ots = reinterpret_cast<float*>(fsel + 4 * 2 * QROWS) + (wg ^ 1) * QROWS;
    unsigned* whist = reinterpret_cast<unsigned*>(fsel + (16 + 4 * MAX_SLOTS) * 2 * QROWS) + (warp % CWARPS) * BINS;
    // Pool form: each (warpgroup, query) publishes J running maxima, each
    // over its own tiles (tile count % J): scores of J distinct rows.  The
    // k-th largest of all splits x J of a query is a floor on its final
    // k-th score, since k distinct rows reach it; a score below it never
    // places.  J: as many as keep splits x J <= CAP and reach 2 k.
    const int J = max(1, min(min(MAX_SLOTS, CAP / splits), (2 * k + splits - 1) / splits));
    const int slots = splits * J;

    if (tid == 0) {
        hopper::mbar_init(q_full, 1);
        for (int s = 0; s < S; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&full[MAX_STAGES + s], 1);
            hopper::mbar_init(&empty[s], C);
        }
        hopper::mbar_fence_init();
    }
    if (warp < CWARPS) {  // each warp's 16 rows of its warpgroup's state
        if constexpr (FORM == LISTS) {
            for (int e = lane; e < 16 * k; e += 32) {
                wls[(warp & 3) * 16 * k + e] = -INFINITY;
                wli[(warp & 3) * 16 * k + e] = INT_MAX;
            }
        }
        if constexpr (FLOORS) {
            for (int e = lane; e < 16 * MAX_SLOTS; e += 32) wpm[(warp & 3) * 16 * MAX_SLOTS + e] = 0u;
            if (lane < 16) {
                const int r = (warp & 3) * 16 + lane;
                wcnt[r] = 0;
                wts[r] = -INFINITY;
                wti[r] = INT_MAX;
                cfl[r] = -INFINITY;
            }
        }
    }
    hopper::cluster_sync();  // the peers' barriers exist before any multicast

    if (warp == CWARPS) {  // the producer warp: one thread issues every load
        if (lane == 0) {
            if (active) {
                hopper::mbar_expect_tx(q_full, P * QPANEL_BYTES);
                for (int p = 0; p < P; ++p)
                    hopper::tma_load_3d(sQ + p * QPANEL_BYTES, &tm_q, q_full, p * COLS, q0, 0);
            }
            const int rows = TILE / C;  // this CTA's share of every panel
            const uint16_t mask = (uint16_t)((1u << C) - 1);
            for (int n = 0; n < total; ++n) {
                const int s = n % S, t = t0 + n / P, p = n % P;
                uint64_t* bar = &full[((n / P) & 1) * MAX_STAGES + s];  // the consuming warpgroup's
                const bool scales = SCALED && p == P - 1;               // K2: a tile's scales with its last panel
                if (n >= S) hopper::mbar_wait(&empty[s], (n / S + 1) & 1);
                hopper::mbar_expect_tx(bar, STAGE_BYTES + (scales ? SCALE_BYTES : 0));  // all C shares land here
                unsigned char* dst = ring + s * STAGE_BYTES + rank * rows * ROW_BYTES;
                if (C == 1) hopper::tma_load_3d(dst, &tm_c, bar, p * COLS, t * TILE, 0);
                else hopper::tma_load_3d_multicast(dst, &tm_c, bar, p * COLS, t * TILE + rank * rows, 0, mask);
                if (scales) hopper::tma_load_1d(scl + s * TILE, &tm_s, bar, t * TILE);
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
        Acc acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = Acc(0);
        uint32_t phases = 0;  // bit s: the parity of this warpgroup's next wait on stage s
        // Element e = 4j + 2i + u of a tile's scores is (row row_a + 8i,
        // column sel_cb + 8j + u); K2's accumulators hold the f32 scores'
        // bits once its epilogue has run, K3's the s32 sums (exact in f32).
        auto score = [&](int e) -> float {
            if constexpr (RAW_AT_READ) return __int2float_rn((int)acc[e]);
            else if constexpr (E::ELEM == 1) return __uint_as_float(acc[e]);
            else return acc[e];
        };

        // A row whose 32 scores here all fall below its threshold has no
        // winner: the max settles most rows once the lists or pools fill.
        // A score below the other warpgroup's k-th score of the row cannot
        // place either: that list or pool holds k other rows at or above
        // it (its k-th score only rises, so a read during an update is
        // safe).  Rows past valid_n exist only in the last tile.
        int sel_cb = 0;

        // ---- the floors (the pool form, and K2's list form) ----
        // the warp's row r: its floor from the published maxima (both
        // warpgroups may write it; any value either writes is a floor)
        auto refresh = [&](int r) {
            const uint32_t key = kth_largest<FORM == POOLS>(glob + (size_t)(q0 + r) * CAP, slots, k, whist, lane);
            if (lane == 0 && key) cfl[r] = fmaxf(cfl[r], key_score(~key));
            __syncwarp();
        };
        // the max of this thread's 32 scores of each of its rows (K3: of
        // the sums, converted once)
        auto row_max = [&](float (&mx)[2]) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if constexpr (RAW_AT_READ) {
                    int m = (int)acc[2 * i];
#pragma unroll
                    for (int j = 0; j < 16; ++j) m = max(m, max((int)acc[4 * j + 2 * i], (int)acc[4 * j + 2 * i + 1]));
                    mx[i] = __int2float_rn(m);
                } else {
                    mx[i] = score(2 * i);
#pragma unroll
                    for (int j = 0; j < 16; ++j)
                        mx[i] = fmaxf(mx[i], fmaxf(score(4 * j + 2 * i), score(4 * j + 2 * i + 1)));
                }
            }
        };
        // Each row's max over the tile's valid rows goes to its published
        // maximum; at the warpgroup's 2J-th and 8J-th tile the warp takes
        // the floors of half its rows (the other warpgroup's warp takes
        // the other half).  sel_cb is the tile's.
        auto publish = [&](int lt, const float (&mx)[2]) {
            const int seen = lt / 2 + 1;
            const bool edge = (t0 + lt) * TILE + TILE > valid_n;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = row_a + 8 * i;
                float pm = mx[i];
                if (edge) {
                    pm = -INFINITY;
#pragma unroll
                    for (int b = 0; b < 32; ++b)
                        if (sel_cb + 8 * (b >> 1) + (b & 1) < valid_n) pm = fmaxf(pm, score(4 * (b >> 1) + 2 * i + (b & 1)));
                }
                pm = fmaxf(pm, __shfl_xor_sync(FULL, pm, 1));
                pm = fmaxf(pm, __shfl_xor_sync(FULL, pm, 2));
                const uint32_t key = ~score_key(pm), slot = r * MAX_SLOTS + (seen - 1) % J;
                if ((lane & 3) == 0 && q0 + r < B && key > wpm[slot]) {
                    wpm[slot] = key;
                    __stcg(glob + (size_t)(q0 + r) * CAP + (cl * 2 + wg) * J + (seen - 1) % J, key);
                }
            }
            if (seen == 2 * J || seen == 8 * J) {
                __syncwarp();
                for (int r = (warp & 3) * 16 + 8 * wg; r < (warp & 3) * 16 + 8 * wg + 8 && q0 + r < B; ++r) refresh(r);
            }
        };

        // ---- the list form ----
        // mask0 / mask1 mark rows row_a / row_a + 8's candidates not yet
        // queued: every score at or above both thresholds (one compare a
        // score; the exact rule, ties to the lower index, is the
        // insertion's, which rejects the rest)
        uint32_t mask0 = 0u, mask1 = 0u;
        bool pending = false;  // warp-uniform
        auto sel_start = [&](int tile) {
            sel_cb = (t0 + tile) * TILE + 2 * (lane & 3);
            float t[2], mx[2];
            bool hit[2];
            row_max(mx);
            if constexpr (FLOORS) publish(tile, mx);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                t[i] = fmaxf(wls[(row_a + 8 * i) * k + k - 1], ols[(row_a + 8 * i) * k + k - 1]);
                if constexpr (FLOORS) t[i] = fmaxf(t[i], cfl[row_a + 8 * i]);
                hit[i] = q0 + row_a + 8 * i < B && mx[i] >= t[i];
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
                    for (int b = 0; b < 32; ++b) m |= (uint32_t)(score(4 * (b >> 1) + 2 * i + (b & 1)) >= t[i]) << b;
                (i == 0 ? mask0 : mask1) = m & valid;
            }
            pending = __any_sync(FULL, (mask0 | mask1) != 0u);
        };
        // One round: the candidates into the quad's part of the warp's queue
        // in lane order (positions from a prefix sum of the quad's lanes'
        // counts; those past its end wait a round), the 8 quads' insertions
        // side by side, and, if some wait, the masks cut to the risen
        // thresholds.
        auto sel_round = [&]() {
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
                            qs[qbase + pos] = score(4 * (bt >> 1) + 2 * i + (bt & 1));
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
                quad_insert<KQ == 0 ? 1 : KQ>(wls + r * k, wli + r * k, k, act ? qs[qbase + e] : 0.f,
                                              act ? qi[qbase + e] : 0, act, lane);
            }
            pending = __any_sync(FULL, (mask0 | mask1) != 0u);
            if (!pending) return;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float t = fmaxf(wls[(row_a + 8 * i) * k + k - 1], ols[(row_a + 8 * i) * k + k - 1]);
                uint32_t keep = 0u;
#pragma unroll
                for (int bt = 0; bt < 32; ++bt) keep |= (uint32_t)(score(4 * (bt >> 1) + 2 * i + (bt & 1)) >= t) << bt;
                (i == 0 ? mask0 : mask1) &= keep;
            }
            pending = __any_sync(FULL, (mask0 | mask1) != 0u);
        };

        // ---- the pool form ----
        // a row's pool: entries of (query q0 + r, split cl * 2 + wg)
        auto pool_at = [&](int r) { return ((size_t)(q0 + r) * splits + cl * 2 + wg) * CAP; };
        // The entries of a tile that beat the row's threshold (exactly: the
        // k-th (score, index) its pool kept) and reach its floor and the
        // other warpgroup's threshold go to the row's pool, each quad's in
        // lane order; a row whose tile would overflow its pool first keeps
        // its best k (the warp selects, row by row) and drops what no longer
        // beats the risen threshold.  Before that, each row's max over the
        // tile's valid rows goes to its published maximum, and at the
        // warpgroup's 2J-th and 8J-th tile the warp takes the floors of
        // half its rows (the other warpgroup's warp takes the other half).
        auto sel_pool = [&](int lt) {
            const int first = (t0 + lt) * TILE;
            const bool edge = first + TILE > valid_n;
            sel_cb = first + 2 * (lane & 3);
            float mx[2];
            row_max(mx);
            publish(lt, mx);
            uint32_t m[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = row_a + 8 * i;
                const float to = fmaxf(ots[r], cfl[r]), ts = wts[r];
                const int ti = wti[r];
                m[i] = 0u;
                if (q0 + r < B && mx[i] >= fmaxf(to, ts)) {
#pragma unroll
                    for (int b = 0; b < 32; ++b) {
                        const float v = score(4 * (b >> 1) + 2 * i + (b & 1));
                        const int n = sel_cb + 8 * (b >> 1) + (b & 1);
                        m[i] |= (uint32_t)(v >= to && beats(v, n, ts, ti) && (!edge || n < valid_n)) << b;
                    }
                }
            }
            if (!__any_sync(FULL, (m[0] | m[1]) != 0u)) return;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = row_a + 8 * i;
                int tot = __popc(m[i]);
                tot += __shfl_xor_sync(FULL, tot, 1);
                tot += __shfl_xor_sync(FULL, tot, 2);
                unsigned over = __ballot_sync(FULL, (lane & 3) == 0 && tot > 0 && wcnt[r] + tot > CAP);
                while (over) {
                    const int src = __ffs(over) - 1;
                    over &= over - 1;
                    const int rr = (warp & 3) * 16 + (src >> 2) + 8 * i;
                    const size_t off = pool_at(rr);
                    refresh(rr);
                    int kept;
                    const uint64_t kth = keep_best(pool_s + off, pool_i + off, wcnt[rr], k, cfl[rr], pool_s + off,
                                                   pool_i + off, nullptr, whist, lane, kept);
                    if (lane == 0) {
                        wcnt[rr] = kept;
                        if (kept == k) {  // else fewer than k passed the floor: the old threshold stands
                            wts[rr] = key_score((uint32_t)(kth >> 32));
                            wti[rr] = (int)(uint32_t)kth;
                        }
                    }
                    __syncwarp();
                    if ((lane >> 2) == (src >> 2)) {
                        const float ts = wts[rr], fl = cfl[rr];
                        const int ti = wti[rr];
#pragma unroll
                        for (int b = 0; b < 32; ++b) {
                            const float v = score(4 * (b >> 1) + 2 * i + (b & 1));
                            if (v < fl || !beats(v, sel_cb + 8 * (b >> 1) + (b & 1), ts, ti)) m[i] &= ~(1u << b);
                        }
                    }
                }
                const int mine = __popc(m[i]);
                int pos = mine;
#pragma unroll
                for (int d = 1; d < 4; d <<= 1) {
                    const int v = __shfl_up_sync(FULL, pos, d, 4);
                    if ((lane & 3) >= d) pos += v;
                }
                tot = __shfl_sync(FULL, pos, 3, 4);
                pos -= mine;
                if (m[i] != 0u) {
                    const size_t off = pool_at(r) + wcnt[r] + pos;
                    int w = 0;
#pragma unroll
                    for (int b = 0; b < 32; ++b)
                        if (m[i] & (1u << b)) {
                            pool_s[off + w] = score(4 * (b >> 1) + 2 * i + (b & 1));
                            pool_i[off + w] = sel_cb + 8 * (b >> 1) + (b & 1);
                            ++w;
                        }
                }
                __syncwarp();  // the quad has read the count before it grows
                if ((lane & 3) == 0 && tot > 0) wcnt[r] += tot;
                __syncwarp();
            }
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
                    E::mma(acc, hopper::desc_k<64, 128>(sQ, QROWS, 0, 4 * p + kq),
                           hopper::desc_k<64, 128>(st, TILE, 0, kq), (p | kq) != 0);
                hopper::wg_commit();
            }
            const int last = lt * P + P - 1;
            if constexpr (E::ELEM == 1 && !RAW_AT_READ) {
                // K2's epilogue, before the stage with the scales goes back:
                // raw sums -> f32 scores in place.  ptxas then serializes the
                // wgmma (C7515: a non-wgmma write to an accumulator), which
                // measured cheaper than converting where a score is read
                // (that kept 64 more values live, and spilled): the int8
                // products are a small part of the ring-bound stream.  K3
                // reads its sums as they are (RAW_AT_READ), with no scales
                // to keep live.
                hopper::wg_wait<0>();
                hopper::fence_regs(acc);
                const float* sc = scl + (last % S) * TILE + 2 * (lane & 3);
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    const float2 v = SCALED ? *reinterpret_cast<const float2*>(sc + 8 * j) : make_float2(1.f, 1.f);
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        acc[4 * j + 2 * i] = __float_as_uint(__int2float_rn((int)acc[4 * j + 2 * i]) * v.x);
                        acc[4 * j + 2 * i + 1] = __float_as_uint(__int2float_rn((int)acc[4 * j + 2 * i + 1]) * v.y);
                    }
                }
            }
            release(last);
            hopper::fence_regs(acc);
            if (!active) continue;
            if constexpr (FORM == LISTS) {
                sel_start(lt);
                while (pending) sel_round();
            } else {
                sel_pool(lt);
            }
        }
        // this warp's rows -> the candidates of (query, cl * 2 + wg): k a
        // query (list form), or the best k of those at or above the row's
        // floor, packed per query behind its count (pool form)
        for (int r = 0; r < 16; ++r) {
            const int row = (warp & 3) * 16 + r;
            if (!active || q0 + row >= B) break;
            if constexpr (FORM == LISTS) {
                const size_t base = ((size_t)(q0 + row) * splits + cl * 2 + wg) * k;
                for (int e = lane; e < k; e += 32) {
                    cand_s[base + e] = wls[row * k + e];
                    cand_i[base + e] = wli[row * k + e];
                }
            } else {
                const size_t off = pool_at(row), base = (size_t)(q0 + row) * splits * k;
                int kept;
                keep_best(pool_s + off, pool_i + off, wcnt[row], k, cfl[row], cand_s + base, cand_i + base,
                          reinterpret_cast<int*>(glob + (size_t)B * CAP) + q0 + row, whist, lane, kept);
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

// the kernel of (element, form, k); the list form by the list entries a
// lane of a quad holds
template <typename E>
inline const void* kernel_of(int form, int k) {
    if (form == POOLS) return (const void*)topk_cluster_kernel<E, 0>;
    return k <= 16 ? (const void*)topk_cluster_kernel<E, 4> : (const void*)topk_cluster_kernel<E, LIST_K / 4>;
}
// (form_for has checked el)
inline const void* kernel_for(int el, int form, int k) {
    return el == EL_S8 ? kernel_of<S8>(form, k) : el == EL_S8_RAW ? kernel_of<S8Raw>(form, k) : kernel_of<Bf16>(form, k);
}

// what: 1 the scan, 2 the merge, 3 both
int launch(int el, const void* q, const void* c, const float* scales, int B, int D, int valid_n, int k, int form,
           int C, int clusters, float* pool_s, int* pool_i, uint32_t* glob, float* cand_s, int* cand_i, float* out_s,
           int* out_i, int what, cudaStream_t st) {
    if (form == NONE || form != form_for(k, D, el) || !(C == 1 || C == 2 || C == 4) || B < 1 || valid_n < k ||
        clusters < 1 || 2 * clusters > CAP || (el == EL_S8 && scales == nullptr) ||
        (form == POOLS && (pool_s == nullptr || pool_i == nullptr)) || (has_floors(k, form, el) && glob == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    if (what & 1) {
        int S = stages_for(k, D, el, form);
        const uint32_t smem = smem_for(k, D, el, form);
        CUtensorMap mq, mc, ms;
        const bool ok = el == EL_BF16 ? hopper::map_bf16_tiles(&mq, q, 1, B, D, QROWS) &&
                                            hopper::map_bf16_tiles(&mc, c, 1, valid_n, D, TILE / C)
                                      : hopper::map_s8_tiles(&mq, q, B, D, QROWS) &&
                                            hopper::map_s8_tiles(&mc, c, valid_n, D, TILE / C) &&
                                            (el != EL_S8 || hopper::map_f32_vector(&ms, scales, (uint64_t)valid_n, TILE));
        if (!ok) return (int)cudaErrorInvalidValue;
        if (el != EL_S8) ms = mc;  // not read
        const void* kern = kernel_for(el, form, k);
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = launch_config(C, clusters * C, hopper::cdiv(B, GROUP_Q), smem, st, &attr);
        void* args[] = {&mq, &mc, &ms, &B, &D, &valid_n, &k, &S, &pool_s, &pool_i, &glob, &cand_s, &cand_i};
        err = cudaLaunchKernelExC(&cfg, kern, args);
        if (err != cudaSuccess) return (int)err;
    }
    if (what & 2) {
        const int* counts = form == POOLS ? reinterpret_cast<const int*>(glob + (size_t)B * CAP) : nullptr;
        topk_merge_kernel<<<B, MERGE_THREADS, 0, st>>>(cand_s, cand_i, 2 * clusters * k, counts, k, out_s, out_i);
        err = cudaGetLastError();
    }
    return (int)err;
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
    topk_merge_kernel<<<B, MERGE_THREADS, 0, stream>>>(cand_s, cand_i, splits * k, nullptr, k, out_s, out_i);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile scan.  kind (Elem): 0 = bf16 corpus (K1), 1 = int8 + per-row
// scales (K2), 2 = int8 raw (K3).  cand_s / cand_i hold B * splits * k
// entries of scratch.
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
        case EL_BF16: return launch_topk<__nv_bfloat16, EL_BF16>(q, c, sc, B, D, valid_n, k, splits, cs, ci, os, oi, st);
        case EL_S8: return launch_topk<signed char, EL_S8>(q, c, sc, B, D, valid_n, k, splits, cs, ci, os, oi, st);
        case EL_S8_RAW: return launch_topk<signed char, EL_S8_RAW>(q, c, sc, B, D, valid_n, k, splits, cs, ci, os, oi, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The cluster scan, then the merge.  el (Elem): 0 = bf16 q (B, D) and
// corpus (K1), 1 = int8 codes with f32 row scales (K2), 2 = int8 codes
// selected on their raw sums (K3; scales not read), all 16-byte aligned;
// form: clus::form_for(k, D, el), 1 lists or 2 pools; C CTAs a cluster (1, 2,
// 4), `clusters` clusters a group of 256 queries.  Pool form: pool_s /
// pool_i hold B * 2 * clusters * 512 entries of scratch, glob B * 513
// zeroed words (the scan's published maxima, then its candidate counts).
// cand_s / cand_i hold B * 2 * clusters * k.  what: 1 the scan, 2 the
// merge, 3 both.
int vqa_topk_cluster(int el, const void* q, const void* c, const void* scales, int B, int D, int valid_n, int k,
                     int form, int C, int clusters, void* pool_s, void* pool_i, void* glob, void* cand_s,
                     void* cand_i, void* out_s, void* out_i, int what, void* stream) {
    return clus::launch(el, q, c, static_cast<const float*>(scales), B, D, valid_n, k, form, C, clusters,
                        static_cast<float*>(pool_s), static_cast<int*>(pool_i), static_cast<uint32_t*>(glob),
                        static_cast<float*>(cand_s),
                        static_cast<int*>(cand_i), static_cast<float*>(out_s), static_cast<int*>(out_i), what,
                        static_cast<cudaStream_t>(stream));
}

// out[6] = clusters of C CTAs the card holds at once, registers a thread,
// dynamic shared memory, local (spill) bytes a thread, ring stages, form
// of the kernel that runs (el, k, D)
int vqa_topk_cluster_info(int el, int C, int k, int D, int* out) {
    const int form = clus::form_for(k, D, el);
    if (form == clus::NONE || !(C == 1 || C == 2 || C == 4)) return (int)cudaErrorInvalidValue;
    const uint32_t smem = clus::smem_for(k, D, el, form);
    const void* kern = clus::kernel_for(el, form, k);
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
    out[4] = clus::stages_for(k, D, el, form);
    out[5] = form;
    return 0;
}

}  // extern "C"
