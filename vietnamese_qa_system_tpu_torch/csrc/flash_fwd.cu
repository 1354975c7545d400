// Flash attention forward (non-causal, kv_lens, optional (H, Tq, Tk) bias)
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel vietnamese_qa_system_tpu/ops/attention.py
// `_fa_kernel` (via `_flash_fwd`) in the form the sentence encoder runs:
// bidirectional attention over right-padded keys (kv_lens) with the MPNet
// relative-position bias.  The causal, sliding-window and key-only (ALiBi)
// forms are not ported yet; the Python wrapper refuses them.
//
// What bounds it on an H100: at the encoder shape (B*H = 3072, T = 512,
// D = 64) the two products are 4*BH*T*T*D = 206 GFLOP per layer, but at
// D = 64 every score also needs an exp, a max, a sum and a bf16 rounding --
// like the TPU kernel (VPU-bound there) this one is bound by the softmax
// arithmetic and shared-memory traffic, not by HBM (q, k, v and o are 4
// bytes per element of (BH, T, D) in all; the f32 bias is read once per
// query tile, 1 MB per head).
//
// Design: one block of 4 warps per (b*h, 64-query tile); a loop over
// 64-key tiles with K and V double-buffered by cp.async; S = Q K^T and the
// P V update on bf16 WMMA with f32 accumulation; running max, sum and the
// output accumulator in f32.  Each warp owns 16 query rows end to end (its
// S rows, softmax, P rows and O rows), so only the K/V tiles need block
// barriers.  The accumulator lives in shared memory between key tiles so
// that the per-row rescale by exp(m_old - m_new) is a plain loop.
// Masked keys take the reference's finite NEG_INF (-1e30), so a row with
// kv_len == 0 (the padding rows every encoder batch carries) averages V
// instead of turning to NaN; keys past Tk take -inf and weigh exactly 0.
// The softmax scale is folded into q by the wrapper, as attention.py:1043
// does.  As in the TPU kernel at D = 64, the row sum adds the bf16-rounded
// probabilities that the P V product uses.

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

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
                 const float* __restrict__ bias, int n_heads, int tq, int tk,
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
    const float* bg = bias == nullptr ? nullptr : bias + (size_t)h * tq * tk;
    const int nk = (tk + BK - 1) / BK;

    load_tile<HD>(sQ, qg, q0, tq, tid);
    load_tile<HD>(sKV, kg, 0, tk, tid);
    load_tile<HD>(sKV + KV_ELEMS, vg, 0, tk, tid);
    cp_async_commit();

    const int r0 = warp * 16;  // this warp's query rows
    for (int e = lane; e < 16 * HD; e += 32) sO[(r0 + e / HD) * L::LDO + e % HD] = 0.f;
    float m[16], l[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) { m[i] = NEG_INF; l[i] = 0.f; }

    for (int t = 0; t < nk; ++t) {
        if (t + 1 < nk) {
            __nv_bfloat16* nxt = sKV + ((t + 1) & 1) * 2 * KV_ELEMS;
            load_tile<HD>(nxt, kg, (t + 1) * BK, tk, tid);
            load_tile<HD>(nxt + KV_ELEMS, vg, (t + 1) * BK, tk, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const __nv_bfloat16* sK = sKV + (t & 1) * 2 * KV_ELEMS;
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

        // online softmax, one row at a time; each lane holds 2 of the 64 keys
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int r = r0 + i, qrow = q0 + r;
            float s[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int c = lane + 32 * u, key = t * BK + c;
                float x = sS[r * L::LDS + c];
                if (key >= tk) x = -INFINITY;
                else if (key >= len) x = NEG_INF;
                else if (bg != nullptr && qrow < tq) x += bg[(size_t)qrow * tk + key];
                s[u] = x;
            }
            float mx = fmaxf(s[0], s[1]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const __nv_bfloat16 p = __float2bfloat16(__expf(s[u] - m_new));
                sP[r * L::LDP + lane + 32 * u] = p;
                sum += __bfloat162float(p);
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

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, const int* kv_lens, const float* bias, int bh,
                 int n_heads, int tq, int tk, void* o, float* lse, cudaStream_t stream) {
    auto kern = flash_fwd_kernel<HD>;
    const int smem = (int)Layout<HD>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((tq + BQ - 1) / BQ, bh);
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                                          static_cast<const __nv_bfloat16*>(v), kv_lens, bias, n_heads, tq, tk,
                                          static_cast<__nv_bfloat16*>(o), lse);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (bh, tq, hd), k and v (bh, tk, hd) bf16; kv_lens (bh,) int32; bias
// (n_heads, tq, tk) f32 or null; o (bh, tq, hd) bf16; lse (bh, tq) f32.
int vqa_flash_fwd(const void* q, const void* k, const void* v, const void* kv_lens, const void* bias, int bh,
                  int n_heads, int tq, int tk, int hd, void* o, void* lse, void* stream) {
    if (bh < 1 || n_heads < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* lens = static_cast<const int*>(kv_lens);
    const float* b = static_cast<const float*>(bias);
    float* ls = static_cast<float*>(lse);
    switch (hd) {
        case 32: return launch_flash<32>(q, k, v, lens, b, bh, n_heads, tq, tk, o, ls, st);
        case 64: return launch_flash<64>(q, k, v, lens, b, bh, n_heads, tq, tk, o, ls, st);
        case 128: return launch_flash<128>(q, k, v, lens, b, bh, n_heads, tq, tk, o, ls, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
