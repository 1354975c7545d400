// Flash attention backward (FA2) for Hopper (sm_90a): dQ, dK and dV from
// the forward's residuals q, k, v and lse, the output cotangent dO and
// dd = rowsum(dO * O), in every form of the forward kernel (bidirectional
// or causal, kv_lens, a causal sliding window, a full (H, Tq, Tk) or
// key-only (H, 1, Tk) additive score bias, whose cotangent is zero).
//
// Replaces the Pallas kernels vietnamese_qa_system_tpu/ops/attention.py
// `_fa_bwd_fused_kernel`, `_fa_bwd_kv_kernel` and `_fa_bwd_q_kernel` (via
// `_flash_bwd_impl`).  The three compute one function; the fused TPU kernel
// keeps full-length (Tk, D) f32 dK/dV accumulators in VMEM, 1 MB at
// T = 1024, D = 128 -- far past the 227 KB of shared memory a block has --
// so this port is the split route, written for the card:
//
// - `flash_bwd_dkdv_kernel`: one block of 4 warps per (b*h, 64-key tile),
//   looping over the 64-query tiles the causal diagonal and the window band
//   leave (Q, dO, lse and dd double-buffered by cp.async).  Each warp owns
//   16 keys: it forms S^T = K Q^T and dP^T = V dO^T for them on bf16 WMMA,
//   recomputes P^T = exp(S^T + bias - lse) under the forward's mask and
//   dS^T = P^T * (dP^T - dd), and accumulates dV += P^T dO and
//   dK += dS^T Q in WMMA accumulator fragments (registers) across the loop.
// - `flash_bwd_dq_kernel`: one block per (b*h, 64-query tile), looping over
//   the key tiles as the forward does (K and V double-buffered); each warp
//   owns 16 queries and accumulates dQ += dS K in registers.
//
// Every output element is written by exactly one block and summed in a
// fixed order: no atomics, so gradients repeat bit for bit from run to
// run.  The softmax scale is folded into q by the caller (the forward's
// wrapper), so the kernels see scale 1 and autograd through the pre-scale
// restores it on dq, as attention.py:1037-1042 does.
//
// What bounds it on an H100: 5 products of (64 x 64 x D) per visited tile
// pair (S and dP twice, once in each kernel, then dV, dK, dQ: 7 in all
// against the fused kernel's 5) against q, k, v, dO, dq, dk, dv read or
// written once -- at the training shape (BH = 96, T = 1024, D = 128,
// causal) about 64 GFLOP over 176 MB: operations, not bytes, bound it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int HD>
struct Strides {
    static constexpr int LDH = HD + 8;   // bf16 row stride of the (64, HD) tiles
    static constexpr int LDS = 64 + 4;   // f32 row stride of the (64, 64) score tiles
    static constexpr int LDP = 64 + 8;   // bf16 row stride of the (64, 64) P / dS tiles
    static constexpr int LDO = HD + 4;   // f32 row stride of the epilogue staging
    static constexpr size_t TILE = (size_t)64 * LDH * 2;  // one (64, HD) bf16 tile
    static constexpr size_t SCORES = (size_t)64 * LDS * 4;
    static constexpr size_t PROBS = (size_t)64 * LDP * 2;
};

// dK/dV kernel: K and V of the block, 2 stages x (Q, dO), S^T and dP^T
// (f32), P^T and dS^T (bf16), 2 stages x (lse, dd)
template <int HD>
struct KVLayout {
    using S = Strides<HD>;
    static constexpr size_t K_OFF = 0;
    static constexpr size_t V_OFF = K_OFF + S::TILE;
    static constexpr size_t QD_OFF = V_OFF + S::TILE;
    static constexpr size_t S_OFF = QD_OFF + 4 * S::TILE;
    static constexpr size_t DP_OFF = S_OFF + S::SCORES;
    static constexpr size_t P_OFF = DP_OFF + S::SCORES;
    static constexpr size_t DS_OFF = P_OFF + S::PROBS;
    static constexpr size_t R_OFF = DS_OFF + S::PROBS;
    static constexpr size_t BYTES = R_OFF + 4 * BQ * 4;
    static_assert((size_t)64 * S::LDO * 4 <= 2 * S::SCORES, "epilogue staging fits in the score tiles");
};

// dQ kernel: Q and dO of the block, 2 stages x (K, V), S and dP (f32), dS
// (bf16), lse and dd
template <int HD>
struct QLayout {
    using S = Strides<HD>;
    static constexpr size_t Q_OFF = 0;
    static constexpr size_t DO_OFF = Q_OFF + S::TILE;
    static constexpr size_t KV_OFF = DO_OFF + S::TILE;
    static constexpr size_t S_OFF = KV_OFF + 4 * S::TILE;
    static constexpr size_t DP_OFF = S_OFF + S::SCORES;
    static constexpr size_t DS_OFF = DP_OFF + S::SCORES;
    static constexpr size_t R_OFF = DS_OFF + S::PROBS;
    static constexpr size_t BYTES = R_OFF + 2 * BQ * 4;
    static_assert((size_t)64 * S::LDO * 4 <= 2 * S::SCORES, "epilogue staging fits in the score tiles");
};

// 64 x HD bf16 tile from a (T, HD) slab; rows at or past `limit` are zeros
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int row0,
                                          int limit, int tid) {
    constexpr int VPR = HD * 2 / 16;  // 16-byte vectors per row
    for (int idx = tid; idx < 64 * VPR; idx += THREADS) {
        const int r = idx / VPR, v = idx % VPR;
        const bool ok = row0 + r < limit;
        const __nv_bfloat16* g = ok ? src + (size_t)(row0 + r) * HD + v * 8 : src;
        cp_async16(dst + r * Strides<HD>::LDH + v * 8, g, ok);
    }
}

// the forward's mask: is key `key` kept for query `qrow`?
__device__ __forceinline__ bool kept(int qrow, int key, int len, int tq, int causal, int window) {
    bool ok = qrow < tq && key < len;
    if (causal) ok = ok && key <= qrow;
    if (window > 0) ok = ok && key > qrow - window;
    return ok;
}

// a (query tile q0, key tile k0) pair needs no mask: every key valid, on or
// below the diagonal of every query and inside every query's band
__device__ __forceinline__ bool clean_pair(int q0, int k0, int len, int tq, int tk, int causal, int window) {
    bool clean = k0 + BK <= len && k0 + BK <= tk && q0 + BQ <= tq;
    if (causal) clean = clean && k0 + BK - 1 <= q0;
    if (window > 0) clean = clean && q0 + BQ - 1 - k0 < window;
    return clean;
}

// C (16 x 64, f32, row stride ldc) = A (16 x HD rows of `a`, row-major) *
// B^T where B is 64 x HD row-major (`b`): the 16 x 64 score block of a warp
template <int HD>
__device__ __forceinline__ void scores16(const __nv_bfloat16* a, const __nv_bfloat16* b, float* c, int ldc) {
    constexpr int LDH = Strides<HD>::LDH;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + kk * 16, LDH);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, b + (j * 16) * LDH + kk * 16, LDH);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(c + j * 16, acc[j], ldc, wmma::mem_row_major);
}

// acc (16 x HD) += A (16 x 64 bf16 rows of `a`, row stride LDP) * B (64 x HD
// row-major tile `b`)
template <int HD>
__device__ __forceinline__ void accumulate16(wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HD / 16],
                                             const __nv_bfloat16* a, const __nv_bfloat16* b) {
    constexpr int LDH = Strides<HD>::LDH, LDP = Strides<HD>::LDP;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + kk * 16, LDP);
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, b + (kk * 16) * LDH + j * 16, LDH);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
    }
}

// write a warp's 16 x HD accumulator as bf16 rows row0.. (< limit) of `dst`
// through the warp's rows of the f32 staging area
template <int HD>
__device__ __forceinline__ void store16(wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HD / 16],
                                        float* stage, __nv_bfloat16* __restrict__ dst, int row0, int limit,
                                        int lane) {
    constexpr int LDO = Strides<HD>::LDO;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::store_matrix_sync(stage + j * 16, acc[j], LDO, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * HD; e += 32) {
        const int r = e / HD, c = e % HD;
        if (row0 + r < limit) dst[(size_t)(row0 + r) * HD + c] = __float2bfloat16(stage[r * LDO + c]);
    }
    __syncwarp();
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dd, const int* __restrict__ kv_lens,
                      const float* __restrict__ bias, int bias_rows, int n_heads, int tq, int tk, int causal,
                      int window, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
    using L = KVLayout<HD>;
    using S = Strides<HD>;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
    __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
    __nv_bfloat16* sQD = reinterpret_cast<__nv_bfloat16*>(smem + L::QD_OFF);
    float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
    float* sDP = reinterpret_cast<float*>(smem + L::DP_OFF);
    __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
    __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + L::DS_OFF);
    float* sR = reinterpret_cast<float*>(smem + L::R_OFF);  // [stage][lse | dd][BQ]
    constexpr size_t TILE_ELEMS = S::TILE / 2;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bh = blockIdx.y, k0 = blockIdx.x * BK;
    const int h = bh % n_heads;
    const int len = kv_lens[bh];
    const size_t qoff = (size_t)bh * tq * HD, koff = (size_t)bh * tk * HD;
    const float* bg = bias == nullptr ? nullptr : bias + (size_t)h * bias_rows * tk;
    const bool key_only = bg != nullptr && bias_rows == 1;
    const int nq = (tq + BQ - 1) / BQ;
    // query tiles that see any key of this tile: not wholly above the
    // diagonal (causal) and not wholly past the band (window)
    const int i_lo = causal ? k0 / BQ : 0;
    int i_hi = nq - 1;
    if (causal && window > 0) i_hi = min(i_hi, (k0 + BK - 1 + window - 1) / BQ);

    const int kr0 = warp * 16;  // this warp's keys
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[HD / 16], dv_acc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
        wmma::fill_fragment(dk_acc[j], 0.f);
        wmma::fill_fragment(dv_acc[j], 0.f);
    }

    if (k0 < len && i_lo <= i_hi) {
        load_tile<HD>(sK, k + koff, k0, tk, tid);
        load_tile<HD>(sV, v + koff, k0, tk, tid);
        auto prefetch = [&](int i, int stage) {
            __nv_bfloat16* dst = sQD + stage * 2 * TILE_ELEMS;
            load_tile<HD>(dst, q + qoff, i * BQ, tq, tid);
            load_tile<HD>(dst + TILE_ELEMS, dout + qoff, i * BQ, tq, tid);
            for (int c = tid; c < BQ; c += THREADS) {
                const int qrow = i * BQ + c;
                sR[stage * 2 * BQ + c] = qrow < tq ? lse[(size_t)bh * tq + qrow] : 0.f;
                sR[stage * 2 * BQ + BQ + c] = qrow < tq ? dd[(size_t)bh * tq + qrow] : 0.f;
            }
        };
        prefetch(i_lo, 0);
        cp_async_commit();

        for (int i = i_lo; i <= i_hi; ++i) {
            const int stage = (i - i_lo) & 1;
            if (i < i_hi) {
                prefetch(i + 1, stage ^ 1);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const __nv_bfloat16* sQ = sQD + stage * 2 * TILE_ELEMS;
            const __nv_bfloat16* sDO = sQ + TILE_ELEMS;
            const float* rl = sR + stage * 2 * BQ;

            // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
            scores16<HD>(sK + kr0 * S::LDH, sQ, sS + kr0 * S::LDS, S::LDS);
            scores16<HD>(sV + kr0 * S::LDH, sDO, sDP + kr0 * S::LDS, S::LDS);
            __syncwarp();

            const int q0 = i * BQ;
            const bool clean = clean_pair(q0, k0, len, tq, tk, causal, window);
            float lse_c[2], dd_c[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                lse_c[u] = rl[lane + 32 * u];
                dd_c[u] = rl[BQ + lane + 32 * u];
            }
#pragma unroll 4
            for (int r = 0; r < 16; ++r) {
                const int kr = kr0 + r, key = k0 + kr;
                const float kb = key_only && key < tk ? bg[key] : 0.f;
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int c = lane + 32 * u, qrow = q0 + c;
                    float x = sS[kr * S::LDS + c] + kb;
                    if (!key_only && bg != nullptr && qrow < tq && key < tk) x += bg[(size_t)qrow * tk + key];
                    const float p = clean || kept(qrow, key, len, tq, causal, window) ? __expf(x - lse_c[u]) : 0.f;
                    const float ds = p * (sDP[kr * S::LDS + c] - dd_c[u]);
                    sP[kr * S::LDP + c] = __float2bfloat16(p);
                    sDS[kr * S::LDP + c] = __float2bfloat16(ds);
                }
            }
            __syncwarp();

            // dV += P^T dO, dK += dS^T Q
            accumulate16<HD>(dv_acc, sP + kr0 * S::LDP, sDO);
            accumulate16<HD>(dk_acc, sDS + kr0 * S::LDP, sQ);
            __syncthreads();  // every warp is done with this stage before it is refilled
        }
    }

    float* stage = sS + (size_t)kr0 * S::LDO;  // the score tiles are free now
    store16<HD>(dk_acc, stage, dk + koff, k0 + kr0, tk, lane);
    store16<HD>(dv_acc, stage, dv + koff, k0 + kr0, tk, lane);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd, const int* __restrict__ kv_lens,
                    const float* __restrict__ bias, int bias_rows, int n_heads, int tq, int tk, int causal,
                    int window, __nv_bfloat16* __restrict__ dq) {
    using L = QLayout<HD>;
    using S = Strides<HD>;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
    __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + L::DO_OFF);
    __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(smem + L::KV_OFF);
    float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
    float* sDP = reinterpret_cast<float*>(smem + L::DP_OFF);
    __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + L::DS_OFF);
    float* sR = reinterpret_cast<float*>(smem + L::R_OFF);  // [lse | dd][BQ]
    constexpr size_t TILE_ELEMS = S::TILE / 2;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
    const int h = bh % n_heads;
    const int len = kv_lens[bh];
    const size_t qoff = (size_t)bh * tq * HD, koff = (size_t)bh * tk * HD;
    const float* bg = bias == nullptr ? nullptr : bias + (size_t)h * bias_rows * tk;
    const bool key_only = bg != nullptr && bias_rows == 1;
    const int nk = (tk + BK - 1) / BK;
    // the forward's key tiles: none wholly above the diagonal or below the band
    int t_lo = 0, t_hi = nk - 1;
    if (causal) {
        t_hi = min(t_hi, (q0 + BQ - 1) / BK);
        if (window > 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / BK;
    }

    load_tile<HD>(sQ, q + qoff, q0, tq, tid);
    load_tile<HD>(sDO, dout + qoff, q0, tq, tid);
    for (int c = tid; c < BQ; c += THREADS) {
        const int qrow = q0 + c;
        sR[c] = qrow < tq ? lse[(size_t)bh * tq + qrow] : 0.f;
        sR[BQ + c] = qrow < tq ? dd[(size_t)bh * tq + qrow] : 0.f;
    }
    load_tile<HD>(sKV, k + koff, t_lo * BK, tk, tid);
    load_tile<HD>(sKV + TILE_ELEMS, v + koff, t_lo * BK, tk, tid);
    cp_async_commit();

    const int qr0 = warp * 16;  // this warp's queries
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.f);

    for (int t = t_lo; t <= t_hi; ++t) {
        const int stage = (t - t_lo) & 1;
        if (t < t_hi) {
            __nv_bfloat16* nxt = sKV + (stage ^ 1) * 2 * TILE_ELEMS;
            load_tile<HD>(nxt, k + koff, (t + 1) * BK, tk, tid);
            load_tile<HD>(nxt + TILE_ELEMS, v + koff, (t + 1) * BK, tk, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const __nv_bfloat16* sK = sKV + stage * 2 * TILE_ELEMS;
        const __nv_bfloat16* sV = sK + TILE_ELEMS;

        // S = Q K^T and dP = dO V^T for this warp's 16 queries
        scores16<HD>(sQ + qr0 * S::LDH, sK, sS + qr0 * S::LDS, S::LDS);
        scores16<HD>(sDO + qr0 * S::LDH, sV, sDP + qr0 * S::LDS, S::LDS);
        __syncwarp();

        const int k0 = t * BK;
        const bool clean = clean_pair(q0, k0, len, tq, tk, causal, window);
        float kb[2] = {0.f, 0.f};  // the key-only bias of this lane's two keys
        if (key_only) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int key = k0 + lane + 32 * u;
                kb[u] = key < tk ? bg[key] : 0.f;
            }
        }
#pragma unroll 4
        for (int r = 0; r < 16; ++r) {
            const int qr = qr0 + r, qrow = q0 + qr;
            const float lse_r = sR[qr], dd_r = sR[BQ + qr];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int c = lane + 32 * u, key = k0 + c;
                float x = sS[qr * S::LDS + c] + kb[u];
                if (!key_only && bg != nullptr && qrow < tq && key < tk) x += bg[(size_t)qrow * tk + key];
                const float p = clean || kept(qrow, key, len, tq, causal, window) ? __expf(x - lse_r) : 0.f;
                sDS[qr * S::LDP + c] = __float2bfloat16(p * (sDP[qr * S::LDS + c] - dd_r));
            }
        }
        __syncwarp();

        // dQ += dS K
        accumulate16<HD>(dq_acc, sDS + qr0 * S::LDP, sK);
        __syncthreads();  // every warp is done with this K/V stage
    }
    cp_async_wait<0>();

    float* stage = sS + (size_t)qr0 * S::LDO;  // the score tiles are free now
    store16<HD>(dq_acc, stage, dq + qoff, q0 + qr0, tq, lane);
}

template <int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
                const int* lens, const float* bias, int bias_rows, int bh, int n_heads, int tq, int tk, int causal,
                int window, void* dk, void* dv, cudaStream_t stream) {
    auto kern = flash_bwd_dkdv_kernel<HD>;
    const int smem = (int)KVLayout<HD>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((tk + BK - 1) / BK, bh);
    using B = __nv_bfloat16;
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const B*>(q), static_cast<const B*>(k),
                                          static_cast<const B*>(v), static_cast<const B*>(dout), lse, dd, lens, bias,
                                          bias_rows, n_heads, tq, tk, causal, window, static_cast<B*>(dk),
                                          static_cast<B*>(dv));
    return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
              const int* lens, const float* bias, int bias_rows, int bh, int n_heads, int tq, int tk, int causal,
              int window, void* dq, cudaStream_t stream) {
    auto kern = flash_bwd_dq_kernel<HD>;
    const int smem = (int)QLayout<HD>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((tq + BQ - 1) / BQ, bh);
    using B = __nv_bfloat16;
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const B*>(q), static_cast<const B*>(k),
                                          static_cast<const B*>(v), static_cast<const B*>(dout), lse, dd, lens, bias,
                                          bias_rows, n_heads, tq, tk, causal, window, static_cast<B*>(dq));
    return (int)cudaGetLastError();
}

bool valid_args(const void* bias, int bias_rows, int bh, int n_heads, int tq, int tk, int causal, int window) {
    if (bh < 1 || n_heads < 1 || tq < 1 || tk < 1 || window < 0 || (window > 0 && !causal)) return false;
    return bias == nullptr || bias_rows == tq || bias_rows == 1;
}

}  // namespace

extern "C" {

// q, dout (bh, tq, hd) and k, v (bh, tk, hd) bf16; lse, dd (bh, tq) f32;
// kv_lens (bh,) int32; bias (n_heads, bias_rows, tk) f32 with bias_rows =
// tq or 1, or null; causal 0/1; window 0 or > 0 (causal only); dk, dv (bh,
// tk, hd) bf16.
int vqa_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* dd, const void* kv_lens, const void* bias, int bias_rows, int bh, int n_heads,
                       int tq, int tk, int hd, int causal, int window, void* dk, void* dv, void* stream) {
    if (!valid_args(bias, bias_rows, bh, n_heads, tq, tk, causal, window)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ls = static_cast<const float*>(lse);
    const float* d = static_cast<const float*>(dd);
    const int* lens = static_cast<const int*>(kv_lens);
    const float* b = static_cast<const float*>(bias);
    switch (hd) {
        case 32: return launch_dkdv<32>(q, k, v, dout, ls, d, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, dk, dv, st);
        case 64: return launch_dkdv<64>(q, k, v, dout, ls, d, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, dk, dv, st);
        case 128: return launch_dkdv<128>(q, k, v, dout, ls, d, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, dk, dv, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// the same inputs; dq (bh, tq, hd) bf16
int vqa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                     const void* kv_lens, const void* bias, int bias_rows, int bh, int n_heads, int tq, int tk,
                     int hd, int causal, int window, void* dq, void* stream) {
    if (!valid_args(bias, bias_rows, bh, n_heads, tq, tk, causal, window)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ls = static_cast<const float*>(lse);
    const float* d = static_cast<const float*>(dd);
    const int* lens = static_cast<const int*>(kv_lens);
    const float* b = static_cast<const float*>(bias);
    switch (hd) {
        case 32: return launch_dq<32>(q, k, v, dout, ls, d, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, dq, st);
        case 64: return launch_dq<64>(q, k, v, dout, ls, d, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, dq, st);
        case 128: return launch_dq<128>(q, k, v, dout, ls, d, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, dq, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
