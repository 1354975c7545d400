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
// What bounds it on an H100: q, k, v and o read or written once against
// the two products, 4 * T * T * D flops per head (half of it causal): at
// the training shape (BH = 96, T = 1024, D = 128) 101 MB (0.030 ms at the
// HBM rate) and 26 GFLOP (0.026 ms at the bf16 peak), at the ingest's
// encoder shape (BH = 3,072, T = 512, D = 64, mixed kv_lens) 824 MB with
// the bias and lse (0.25 ms) and at most 206 GFLOP (0.21 ms).  The two
// are close, so the products must run near the tensor cores' rate, which
// they reach only through wgmma fed from shared memory that TMA fills,
// with the softmax kept off the products' path.
//
// Design (hopper.cuh has the building blocks):
// - a block per (b*h, 128-query tile) of two warpgroups of 64 query rows
//   each.  TMA brings Q once and K, V and the bias tile through a 2-stage
//   ring completed on mbarriers; the warpgroup that frees a stage second
//   issues its next loads at once (release_stage), so the loads run a
//   stage ahead of both.  A producer warpgroup with setmaxnreg (24 / 240)
//   was built first: ptxas held every variant to the 168 registers that
//   384 threads allow, not giving the consumers setmaxnreg's budget, and
//   the D = 128 forms spilled; 256 threads have 255 registers each.
// - S = Q K^T by wgmma from the swizzled shared tiles into registers; the
//   online softmax in registers: each thread holds two rows' pieces, the
//   row max is a local max and two quad shuffles, the row sum stays a
//   per-thread partial until the end; P goes bf16 straight from the S
//   registers into the A operand of O += P V (wgmma with A from registers,
//   V as the MN-major B operand).  O stays in registers for the whole key
//   loop and is rescaled there; no score or output tile touches shared
//   memory.
// - key tiles: the causal diagonal and the window band skip whole tiles as
//   before, and a row with kv_len > 0 stops at ceil(kv_len / BK) -- tiles
//   past it hold only keys whose weight exp(-1e30 - m) is exactly 0.  A row
//   that keeps no key at all (kv_len == 0: the padding rows of every
//   encoder batch) averages V over every key, as the reference's finite
//   NEG_INF gives, so a block holding such a row visits every tile
//   (key_tile_range).  Each consumer warpgroup further skips tiles that
//   hold no kept key of its own 64 rows.  Interior tiles skip the mask.
// - causal blocks run heaviest first (the query tiles at the bottom of the
//   diagonal), so the last wave is not one long tile.
// - the full bias tile (128 x 64 f32) rides the ring, loaded only for
//   tiles that hold a key below kv_len; the key-only bias is one 128-vector
//   a tile.  Keys past Tk take -inf; the bias is added before the mask.
// As in the TPU kernel, the row sum adds the bf16-rounded probabilities
// that the P V product uses when D % 128 != 0 and the f32 ones at D = 128.
// The softmax scale is folded into q by the wrapper.  Each form (causal or
// not, no / full / key-only bias) is its own compiled variant.

#include <math.h>
#include <string.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;  // two consumer warpgroups

template <int HD, bool CAUSAL, int BIAS>
struct Fwd {
    static constexpr int BQ = 128;                  // two consumer warpgroups of 64 rows
    static constexpr int BK = BIAS == 1 ? 64 : 128;  // the full bias tile is 4 B an element
    static constexpr int STAGES = 2;
    static constexpr int SWB = HD >= 64 ? 128 : 64;  // swizzle span = a panel row's bytes
    static constexpr uint32_t Q_BYTES = BQ * HD * 2, KV_BYTES = BK * HD * 2;
    static constexpr uint32_t BIAS_BYTES = BIAS == 1 ? BQ * BK * 4 : BIAS == 2 ? BK * 4 : 0;
    static constexpr uint32_t BIAS_SLOT = (BIAS_BYTES + 1023) / 1024 * 1024;
    static constexpr uint32_t Q_OFF = 0, K_OFF = Q_BYTES, V_OFF = K_OFF + STAGES * KV_BYTES,
                              B_OFF = V_OFF + STAGES * KV_BYTES, BAR_OFF = B_OFF + STAGES * BIAS_SLOT;
    // mbarriers (Q, then one a stage) and the stages' release counters
    static constexpr uint32_t SMEM = BAR_OFF + 8 * (1 + STAGES) + 4 * STAGES;
};

template <int HD, bool CAUSAL, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_b,
                 const int* __restrict__ kv_lens, int n_heads, int tq, int tk, int window,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
    using F = Fwd<HD, CAUSAL, BIAS>;
    constexpr int BQ = F::BQ, BK = F::BK, SWB = F::SWB, S = F::STAGES;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + F::BAR_OFF);
    uint64_t* full = q_full + 1;
    uint32_t* released = reinterpret_cast<uint32_t*>(full + S);

    const int bh = blockIdx.x, h = bh % n_heads;
    const int nq = cdiv(tq, BQ);
    const int q0 = (CAUSAL ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
    const int len = kv_lens[bh];
    int lo, hi;
    key_tile_range(q0, BQ, BK, tq, tk, len, CAUSAL, window, true, lo, hi);
    const int n_tiles = hi - lo + 1;

    // the loads of the n-th visited key tile into its stage
    auto issue = [&](int n) {
        const int t = lo + n, s = n % S;
        const bool with_bias = BIAS != 0 && t * BK < len;
        mbar_expect_tx(&full[s], 2 * F::KV_BYTES + (with_bias ? F::BIAS_BYTES : 0));
        tma_tile<HD, SWB>(smem + F::K_OFF + s * F::KV_BYTES, &tm_k, &full[s], BK, t * BK, bh);
        tma_tile<HD, SWB>(smem + F::V_OFF + s * F::KV_BYTES, &tm_v, &full[s], BK, t * BK, bh);
        unsigned char* sb = smem + F::B_OFF + s * F::BIAS_SLOT;
        if (BIAS == 1 && with_bias)
            for (int p = 0; p < BK / 32; ++p) tma_load_3d(sb + p * BQ * 128, &tm_b, &full[s], t * BK + 32 * p, q0, h);
        if (BIAS == 2 && with_bias) tma_load_1d(sb, &tm_b, &full[s], h * f32_pitch(tk) + t * BK);
    };

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            released[s] = 0;
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(q_full, F::Q_BYTES);
        tma_tile<HD, SWB>(smem + F::Q_OFF, &tm_q, q_full, BQ, q0, bh);
        for (int n = 0; n < S && n < n_tiles; ++n) issue(n);
    }
    __syncwarp();
    {
        const int cw = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        const int qw0 = q0 + 64 * cw;                      // this warpgroup's first row
        const int ra = qw0 + warp * 16 + (lane >> 2);      // this thread's rows: ra, ra + 8
        const int cq = 2 * (lane & 3);                     // its columns in each 8-column chunk
        int wlo, whi;
        key_tile_range(qw0, 64, BK, tq, tk, len, CAUSAL, window, true, wlo, whi);

        float acc_o[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc_o[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
        const unsigned char* sQ = smem + F::Q_OFF;
        mbar_wait(q_full, 0);

        for (int t = lo; t <= hi; ++t) {
            const int n = t - lo, s = n % S;
            mbar_wait(&full[s], (n / S) & 1);
            if (t >= wlo && t <= whi) {
                const unsigned char* sK = smem + F::K_OFF + s * F::KV_BYTES;
                const unsigned char* sV = smem + F::V_OFF + s * F::KV_BYTES;
                const float* sB = reinterpret_cast<const float*>(smem + F::B_OFF + s * F::BIAS_SLOT);

                // S = Q K^T for this warpgroup's 64 rows
                float acc_s[BK / 2];
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk)
                    wgmma_ss<BK>(acc_s, desc_k<HD, SWB>(sQ, BQ, 64 * cw, kk), desc_k<HD, SWB>(sK, BK, 0, kk), kk > 0);
                wg_commit();
                wg_wait<0>();
                fence_regs(acc_s);

                // bias and mask; interior tiles (every key valid, on or below
                // the diagonal and inside the band of every row) skip the mask
                const int k0 = t * BK;
                bool clean = k0 + BK <= len && k0 + BK <= tk;
                if (CAUSAL) clean = clean && k0 + BK - 1 <= qw0 && (window <= 0 || qw0 + 63 - k0 < window);
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    const int c = 8 * j + cq;
                    float2 kb = make_float2(0.f, 0.f);
                    if (BIAS == 2) kb = *reinterpret_cast<const float2*>(sB + c);
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int row = ra + 8 * i, lr = row - q0;
#pragma unroll
                        for (int u = 0; u < 2; ++u) {
                            float x = acc_s[4 * j + 2 * i + u];
                            if (BIAS == 2) x += u ? kb.y : kb.x;
                            const int key = k0 + c + u;
                            if (clean) {
                                if (BIAS == 1) x += f32_tile_at(sB, BQ, lr, c + u);
                            } else {
                                bool keep = key < len;
                                if (CAUSAL) keep = keep && key <= row && (window <= 0 || key > row - window);
                                if (key >= tk) x = -INFINITY;
                                else if (!keep) x = NEG_INF;
                                else if (BIAS == 1) x += f32_tile_at(sB, BQ, lr, c + u);
                            }
                            acc_s[4 * j + 2 * i + u] = x;
                        }
                    }
                }

                // online softmax in registers
                float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    float mx = -INFINITY;
#pragma unroll
                    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(acc_s[4 * j + 2 * i], acc_s[4 * j + 2 * i + 1]));
                    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
                    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
                    const float m_new = fmaxf(m[i], mx);
                    alpha[i] = __expf(m[i] - m_new);
                    m[i] = m_new;
                }
#pragma unroll
                for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int u = 0; u < 2; ++u) {
                            const float e = __expf(acc_s[4 * j + 2 * i + u] - m[i]);
                            sum[i] += (HD % 128 == 0) ? e : __bfloat162float(__float2bfloat16(e));
                            acc_s[4 * j + 2 * i + u] = e;
                        }
#pragma unroll
                for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
                for (int j = 0; j < HD / 8; ++j)
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        acc_o[4 * j + 2 * i] *= alpha[i];
                        acc_o[4 * j + 2 * i + 1] *= alpha[i];
                    }

                // O += P V, P from registers
                uint32_t pa[BK / 16][4];
                pack_a<BK>(acc_s, pa);
                fence_regs(acc_o);
                fence_regs(pa);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<HD>(acc_o, pa[kk], desc_mn<HD, SWB>(sV, BK, kk));
                wg_commit();
                wg_wait<0>();
                fence_regs(acc_o);
                fence_regs(pa);
            }
            release_stage(&released[s], cw, [&] {
                if (n + S < n_tiles) issue(n + S);
            });
        }

        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[i] += __shfl_xor_sync(FULL, l[i], 1);
            l[i] += __shfl_xor_sync(FULL, l[i], 2);
            const float denom = fmaxf(l[i], 1e-30f);
            inv[i] = 1.f / denom;
            const int row = ra + 8 * i;
            if ((lane & 3) == 0 && row < tq) lse[(size_t)bh * tq + row] = m[i] + logf(denom);
        }
        store_rows<HD>(acc_o, o + (size_t)bh * tq * HD, qw0, tq, inv[0], inv[1]);
    }
}

template <int HD, bool CAUSAL, int BIAS>
int launch_form(const void* q, const void* k, const void* v, const int* kv_lens, const float* bias, int bh,
                int n_heads, int tq, int tk, int window, void* o, float* lse, cudaStream_t stream) {
    using F = Fwd<HD, CAUSAL, BIAS>;
    CUtensorMap mq, mk, mv, mb;
    memset(&mb, 0, sizeof(mb));
    const int ldb = f32_pitch(tk);
    bool ok = map_bf16_tiles(&mq, q, bh, tq, HD, F::BQ) && map_bf16_tiles(&mk, k, bh, tk, HD, F::BK) &&
              map_bf16_tiles(&mv, v, bh, tk, HD, F::BK);
    if (BIAS == 1) ok = ok && map_f32_tiles(&mb, bias, n_heads, tq, ldb, F::BQ);
    if (BIAS == 2) ok = ok && map_f32_vector(&mb, bias, (uint64_t)n_heads * ldb, F::BK);
    if (!ok) return (int)cudaErrorInvalidValue;
    auto kern = flash_fwd_kernel<HD, CAUSAL, BIAS>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::SMEM);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&mq, &mk, &mv, &mb, &kv_lens, &n_heads, &tq, &tk, &window, &o, &lse};
    err = cudaLaunchKernel((const void*)kern, dim3(bh, cdiv(tq, F::BQ)), dim3(THREADS), args, F::SMEM, stream);
    return (int)err;
}

// registers, shared memory, blocks per SM, local (spill) bytes, BK and BQ of a form
template <int HD, bool CAUSAL, int BIAS>
int form_info(int* out) {
    using F = Fwd<HD, CAUSAL, BIAS>;
    auto kern = flash_fwd_kernel<HD, CAUSAL, BIAS>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::SMEM);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, (const void*)kern);
    int blocks = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, F::SMEM);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)F::SMEM;
    out[2] = blocks;
    out[3] = (int)attr.localSizeBytes;
    out[4] = F::BK;
    out[5] = F::BQ;
    return 0;
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

template <int HD, bool CAUSAL>
int info_bias(int bias_kind, int* out) {
    if (bias_kind == 0) return form_info<HD, CAUSAL, 0>(out);
    if (bias_kind == 2) return form_info<HD, CAUSAL, 2>(out);
    return form_info<HD, CAUSAL, 1>(out);
}

template <int HD>
int info_form(int causal, int bias_kind, int* out) {
    return causal ? info_bias<HD, true>(bias_kind, out) : info_bias<HD, false>(bias_kind, out);
}

}  // namespace

extern "C" {

// q (bh, tq, hd), k and v (bh, tk, hd) bf16, 16-byte aligned; kv_lens (bh,)
// int32; bias (n_heads, bias_rows, ldb) f32 with bias_rows = tq (full) or 1
// (key-only) and rows padded to ldb = tk rounded up to a multiple of 4 (TMA
// strides are 16-byte multiples), or null; causal 0/1; window 0 (none) or
// > 0 (causal only); o (bh, tq, hd) bf16; lse (bh, tq) f32.
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

// out[6] = registers a thread, dynamic shared memory, blocks per SM, local
// bytes a thread (spills) and the key and query tiles of the form (hd,
// causal, bias 0 none / 1 full / 2 key-only)
int vqa_flash_fwd_info(int hd, int causal, int bias_kind, int* out) {
    switch (hd) {
        case 32: return info_form<32>(causal, bias_kind, out);
        case 64: return info_form<64>(causal, bias_kind, out);
        case 128: return info_form<128>(causal, bias_kind, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
