// Flash attention forward for Hopper (sm_90a): every form of the TPU
// kernel -- bidirectional or causal, per-row key lengths (kv_lens), a
// causal sliding window, and an additive score bias that is either full
// (H, Tq, Tk) or key-only (H, 1, Tk).
//
// Replaces the Pallas kernel vietnamese_qa_system_tpu/ops/attention.py
// `_fa_kernel` (via `_flash_fwd`).  The sentence encoder runs the
// bidirectional form over right-padded keys with the MPNet relative bias;
// the causal LM's cache-less forward (training) runs the causal form with
// the MPT/BLOOM ALiBi key-only bias, and GPT-Neo's local layers the
// causal sliding window.  Masking is the TPU kernel's: a key is kept iff
// k < min(kv_len, q + 1) (causal) or k < kv_len, and, with a window, also
// k > q - window.
//
// What bounds it on an H100: at the encoder shape (B*H = 3072, T = 512,
// D = 64) the two products are 4*BH*T*T*D = 206 GFLOP per layer, but at
// D = 64 every score also needs an exp, a max, a sum and a bf16 rounding --
// like the TPU kernel (VPU-bound there) this one is bound by the softmax
// arithmetic and shared-memory traffic, not by HBM (q, k, v and o are 4
// bytes per element of (BH, T, D) in all; the f32 bias is read once per
// query tile, 1 MB per head).  Causal at the training shape (BH = 96,
// T = 1024, D = 128) skips the tiles above the diagonal: half the products.
//
// Design: one block of 4 warps per (b*h, 64-query tile); a loop over the
// 64-key tiles that the causal diagonal and the window band leave (tiles
// wholly above the diagonal or wholly outside the band are never loaded),
// with K and V double-buffered by cp.async; S = Q K^T and the P V update on
// bf16 WMMA with f32 accumulation; running max, sum and the output
// accumulator in f32.  Each warp owns 16 query rows end to end (its S rows,
// softmax, P rows and O rows), so only the K/V tiles need block barriers.
// The accumulator lives in shared memory between key tiles so that the
// per-row rescale by exp(m_old - m_new) is a plain loop.  Interior tiles
// (every key valid, on or below the diagonal, inside the band) skip the
// mask; the diagonal, band-edge and ragged tiles are masked.  A key-only
// bias is read once per key tile by each lane and broadcast over the
// query rows.  Masked keys take the reference's finite NEG_INF (-1e30), so
// a row with kv_len == 0 (the padding rows every encoder batch carries)
// averages V instead of turning to NaN; keys past Tk take -inf and weigh
// exactly 0.  The softmax scale is folded into q by the wrapper, as
// attention.py:1043 does.  As in the TPU kernel, the row sum adds the
// bf16-rounded probabilities that the P V product uses when D % 128 != 0
// (its ones-column trick) and the f32 probabilities at D = 128.  Each
// form (causal or not, no / full / key-only bias) is its own compiled
// variant, so the encoder's form carries none of the training forms' code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int HD>
struct Layout {
    static constexpr int LDH = HD + 8;   // bf16 row stride of Q, K, V tiles
    static constexpr int LDP = BK + 8;   // bf16 row stride of P
    static constexpr int LDS = BK + 4;   // f32 row stride of S
    static constexpr int LDO = HD + 4;   // f32 row stride of O
    static constexpr size_t Q_OFF = 0;
    static constexpr size_t KV_OFF = Q_OFF + (size_t)BQ * LDH * 2;
    static constexpr size_t KV_TILE = (size_t)BK * LDH * 2;         // one K or V tile
    static constexpr size_t S_OFF = KV_OFF + 4 * KV_TILE;           // 2 stages x (K, V)
    static constexpr size_t P_OFF = S_OFF + (size_t)BQ * LDS * 4;
    static constexpr size_t O_OFF = P_OFF + (size_t)BQ * LDP * 2;
    static constexpr size_t A_OFF = O_OFF + (size_t)BQ * LDO * 4;
    static constexpr size_t BYTES = A_OFF + BQ * 4;
};

// rows x HD bf16 tile from a (T, HD) slab; rows at or past `limit` are zeros
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int row0,
                                          int limit, int tid) {
    constexpr int VPR = HD * 2 / 16;  // 16-byte vectors per row
    for (int idx = tid; idx < BK * VPR; idx += THREADS) {
        const int r = idx / VPR, v = idx % VPR;
        const bool ok = row0 + r < limit;
        const __nv_bfloat16* g = ok ? src + (size_t)(row0 + r) * HD + v * 8 : src;
        cp_async16(dst + r * Layout<HD>::LDH + v * 8, g, ok);
    }
}

// The range [lo, hi] of key tiles that a 64-query tile starting at q0 must
// visit: all of them bidirectionally; causally none wholly above the
// diagonal and, with a window, none wholly below the band.
__device__ __forceinline__ void key_tile_range(int q0, int nk, int causal, int window, int& lo, int& hi) {
    lo = 0;
    hi = nk - 1;
    if (causal) {
        hi = min(hi, (q0 + BQ - 1) / BK);
        if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / BK;
    }
}

// The form is compile-time: CAUSAL, and BIAS 0 (none), 1 (full (H, Tq,
// Tk)) or 2 (key-only (H, 1, Tk)); the window (causal only) is a runtime
// width, 0 for none.
template <int HD, bool CAUSAL, int BIAS>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
                 const float* __restrict__ bias, int n_heads, int tq, int tk, int window,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
    using L = Layout<HD>;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
    __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(smem + L::KV_OFF);
    float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
    __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
    float* sO = reinterpret_cast<float*>(smem + L::O_OFF);
    float* sAlpha = reinterpret_cast<float*>(smem + L::A_OFF);
    constexpr size_t KV_ELEMS = L::KV_TILE / 2;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
    const int h = bh % n_heads;
    const int len = kv_lens[bh];
    const __nv_bfloat16* qg = q + (size_t)bh * tq * HD;
    const __nv_bfloat16* kg = k + (size_t)bh * tk * HD;
    const __nv_bfloat16* vg = v + (size_t)bh * tk * HD;
    // bias rows: tq for the full form, 1 for the key-only form (row 0 for all)
    const float* bg = BIAS == 0 ? nullptr : bias + (size_t)h * (BIAS == 2 ? 1 : tq) * tk;
    const int nk = (tk + BK - 1) / BK;
    int t_lo, t_hi;
    key_tile_range(q0, nk, CAUSAL, window, t_lo, t_hi);

    load_tile<HD>(sQ, qg, q0, tq, tid);
    load_tile<HD>(sKV, kg, t_lo * BK, tk, tid);
    load_tile<HD>(sKV + KV_ELEMS, vg, t_lo * BK, tk, tid);
    cp_async_commit();

    const int r0 = warp * 16;  // this warp's query rows
    for (int e = lane; e < 16 * HD; e += 32) sO[(r0 + e / HD) * L::LDO + e % HD] = 0.f;
    float m[16], l[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) { m[i] = NEG_INF; l[i] = 0.f; }

    for (int t = t_lo; t <= t_hi; ++t) {
        const int stage = (t - t_lo) & 1;
        if (t < t_hi) {
            __nv_bfloat16* nxt = sKV + (stage ^ 1) * 2 * KV_ELEMS;
            load_tile<HD>(nxt, kg, (t + 1) * BK, tk, tid);
            load_tile<HD>(nxt + KV_ELEMS, vg, (t + 1) * BK, tk, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const __nv_bfloat16* sK = sKV + stage * 2 * KV_ELEMS;
        const __nv_bfloat16* sV = sK + KV_ELEMS;

        // S = Q K^T for this warp's 16 rows
        {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
            for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::load_matrix_sync(a, sQ + r0 * L::LDH + kk * 16, L::LDH);
#pragma unroll
                for (int j = 0; j < BK / 16; ++j) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
                    wmma::load_matrix_sync(b, sK + (j * 16) * L::LDH + kk * 16, L::LDH);
                    wmma::mma_sync(acc[j], a, b, acc[j]);
                }
            }
#pragma unroll
            for (int j = 0; j < BK / 16; ++j)
                wmma::store_matrix_sync(sS + r0 * L::LDS + j * 16, acc[j], L::LDS, wmma::mem_row_major);
        }
        __syncwarp();

        // interior tile: every key valid, on or below the diagonal of every
        // row of the block and inside every row's band -- no mask needed
        const int k0 = t * BK;
        bool clean = k0 + BK <= len && k0 + BK <= tk;
        if (CAUSAL) clean = clean && k0 + BK - 1 <= q0;
        if (CAUSAL && window > 0) clean = clean && q0 + BQ - 1 - k0 < window;
        float kb[2] = {0.f, 0.f};  // the key-only bias of this lane's two keys
        if (BIAS == 2) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int key = k0 + lane + 32 * u;
                kb[u] = key < tk ? bg[key] : 0.f;
            }
        }

        // online softmax, one row at a time; each lane holds 2 of the 64 keys
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int r = r0 + i, qrow = q0 + r;
            float s[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int c = lane + 32 * u, key = k0 + c;
                float x = sS[r * L::LDS + c];
                if (BIAS == 2) x += kb[u];
                // the full bias is read only for kept keys (padding keys of
                // encoder rows are many)
                if (clean) {
                    if (BIAS == 1 && qrow < tq) x += bg[(size_t)qrow * tk + key];
                } else {
                    bool keep = key < len;
                    if (CAUSAL) keep = keep && key <= qrow;
                    if (CAUSAL && window > 0) keep = keep && key > qrow - window;
                    if (key >= tk) x = -INFINITY;
                    else if (!keep) x = NEG_INF;
                    else if (BIAS == 1 && qrow < tq) x += bg[(size_t)qrow * tk + key];
                }
                s[u] = x;
            }
            float mx = fmaxf(s[0], s[1]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const float e = __expf(s[u] - m_new);
                const __nv_bfloat16 p = __float2bfloat16(e);
                sP[r * L::LDP + lane + 32 * u] = p;
                sum += (HD % 128 == 0) ? e : __bfloat162float(p);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
            const float alpha = __expf(m[i] - m_new);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
            if (lane == 0) sAlpha[r] = alpha;
        }
        __syncwarp();

        // O = O * alpha + P V
        for (int e = lane; e < 16 * HD; e += 32) {
            const int r = r0 + e / HD;
            sO[r * L::LDO + e % HD] *= sAlpha[r];
        }
        __syncwarp();
        {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[HD / 16];
#pragma unroll
            for (int j = 0; j < HD / 16; ++j)
                wmma::load_matrix_sync(acc[j], sO + r0 * L::LDO + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::load_matrix_sync(a, sP + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
                for (int j = 0; j < HD / 16; ++j) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
                    wmma::load_matrix_sync(b, sV + (kk * 16) * L::LDH + j * 16, L::LDH);
                    wmma::mma_sync(acc[j], a, b, acc[j]);
                }
            }
#pragma unroll
            for (int j = 0; j < HD / 16; ++j)
                wmma::store_matrix_sync(sO + r0 * L::LDO + j * 16, acc[j], L::LDO, wmma::mem_row_major);
        }
        __syncthreads();  // every warp is done with this K/V stage
    }

#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const int r = r0 + i, qrow = q0 + r;
        if (qrow >= tq) break;
        const float denom = fmaxf(l[i], 1e-30f);
        __nv_bfloat16* og = o + ((size_t)bh * tq + qrow) * HD;
        for (int d = lane; d < HD; d += 32) og[d] = __float2bfloat16(sO[r * L::LDO + d] / denom);
        if (lane == 0) lse[(size_t)bh * tq + qrow] = m[i] + logf(denom);
    }
}

template <int HD, bool CAUSAL, int BIAS>
int launch_form(const void* q, const void* k, const void* v, const int* kv_lens, const float* bias, int bh,
                int n_heads, int tq, int tk, int window, void* o, float* lse, cudaStream_t stream) {
    auto kern = flash_fwd_kernel<HD, CAUSAL, BIAS>;
    const int smem = (int)Layout<HD>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((tq + BQ - 1) / BQ, bh);
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                                          static_cast<const __nv_bfloat16*>(v), kv_lens, bias, n_heads, tq, tk,
                                          window, static_cast<__nv_bfloat16*>(o), lse);
    return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_bias(const void* q, const void* k, const void* v, const int* kv_lens, const float* bias, int bias_rows,
                int bh, int n_heads, int tq, int tk, int window, void* o, float* lse, cudaStream_t stream) {
    if (bias == nullptr) return launch_form<HD, CAUSAL, 0>(q, k, v, kv_lens, bias, bh, n_heads, tq, tk, window, o, lse, stream);
    if (bias_rows == 1) return launch_form<HD, CAUSAL, 2>(q, k, v, kv_lens, bias, bh, n_heads, tq, tk, window, o, lse, stream);
    return launch_form<HD, CAUSAL, 1>(q, k, v, kv_lens, bias, bh, n_heads, tq, tk, window, o, lse, stream);
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, const int* kv_lens, const float* bias, int bias_rows,
                 int bh, int n_heads, int tq, int tk, int causal, int window, void* o, float* lse,
                 cudaStream_t stream) {
    if (causal) return launch_bias<HD, true>(q, k, v, kv_lens, bias, bias_rows, bh, n_heads, tq, tk, window, o, lse, stream);
    return launch_bias<HD, false>(q, k, v, kv_lens, bias, bias_rows, bh, n_heads, tq, tk, 0, o, lse, stream);
}

}  // namespace

extern "C" {

// q (bh, tq, hd), k and v (bh, tk, hd) bf16; kv_lens (bh,) int32; bias
// (n_heads, bias_rows, tk) f32 with bias_rows = tq (full) or 1 (key-only),
// or null; causal 0/1; window 0 (none) or > 0 (causal only); o (bh, tq,
// hd) bf16; lse (bh, tq) f32.
int vqa_flash_fwd(const void* q, const void* k, const void* v, const void* kv_lens, const void* bias, int bias_rows,
                  int bh, int n_heads, int tq, int tk, int hd, int causal, int window, void* o, void* lse,
                  void* stream) {
    if (bh < 1 || n_heads < 1 || tq < 1 || tk < 1 || window < 0 || (window > 0 && !causal))
        return (int)cudaErrorInvalidValue;
    if (bias != nullptr && bias_rows != tq && bias_rows != 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* lens = static_cast<const int*>(kv_lens);
    const float* b = static_cast<const float*>(bias);
    float* ls = static_cast<float*>(lse);
    switch (hd) {
        case 32: return launch_flash<32>(q, k, v, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, o, ls, st);
        case 64: return launch_flash<64>(q, k, v, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, o, ls, st);
        case 128:
            return launch_flash<128>(q, k, v, lens, b, bias_rows, bh, n_heads, tq, tk, causal, window, o, ls, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
