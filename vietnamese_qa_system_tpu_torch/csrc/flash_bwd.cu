// Flash attention backward (FA2 split) for Hopper (sm_90a): dQ, dK and dV
// from the forward's residuals q, k, v and lse, the output cotangent dO
// and dd = rowsum(dO * O), in every form of the forward kernel
// (bidirectional or causal, kv_lens, a causal sliding window, a full
// (H, Tq, Tk) or key-only (H, 1, Tk) additive score bias, whose cotangent
// is zero).  dd is plain torch in the wrapper (ops/attention.py), as it is
// XLA in the JAX package.
//
// Replaces the Pallas kernels vietnamese_qa_system_tpu/ops/attention.py
// `_fa_bwd_fused_kernel`, `_fa_bwd_kv_kernel` and `_fa_bwd_q_kernel` (via
// `_flash_bwd_impl`).  The three compute one function; the fused TPU kernel
// keeps full-length (Tk, D) f32 dK/dV accumulators in VMEM, 1 MB at
// T = 1024, D = 128 -- far past the 227 KB of shared memory a block has --
// so this port is the split route, written for the card.
//
// What bounds it on an H100: 7 products of (64 x 64 x D) per kept tile pair
// (S and dP in each kernel, then dV, dK, dQ) against q, k, v, dO, dq, dk,
// dv read or written once -- at the training shape (BH = 96, T = 1024,
// D = 128, causal) about 90 GFLOP over 176 MB: operations bound it, and
// the tensor cores reach their rate only through wgmma.
//
// Design (the forward's toolbox, hopper.cuh): blocks of two warpgroups,
// 255 registers a thread (the dK/dV warpgroups hold 128 accumulator
// registers at D = 128), fed by TMA through a 2-stage mbarrier ring that
// the warpgroup freeing a stage second refills (release_stage).
// - `flash_bwd_dkdv_kernel`: a block per (b*h, 128 keys), 64 keys a
//   consumer warpgroup; K and V come once, Q, dO, lse and dd (and the full
//   bias tile) per 64-query tile.  S^T = K Q^T and dP^T = V dO^T are wgmma
//   products with K and V as shared A operands; P^T = exp(S^T + bias - lse)
//   under the forward's mask and dS^T = P^T (dP^T - dd) are formed in the
//   accumulator registers and fed, rounded to bf16, from registers as the
//   A operands of dV += P^T dO and dK += dS^T Q (dO and Q as MN-major B
//   operands).  dK and dV stay in registers across the query loop.  Key
//   tiles at or past kv_len meet no kept pair: such blocks write zeros
//   without looping.
// - `flash_bwd_dq_kernel`: a block per (b*h, 128 queries), 64 a consumer
//   warpgroup; Q and dO come once, K, V (and the bias tile) per 64-key
//   tile.  S and dP by wgmma, dS in registers, dQ += dS K with dS from
//   registers and K as the MN-major B operand; dQ in registers.  The key
//   tiles are the forward's (key_tile_range) less the tiles past kv_len
//   for every row: a row that keeps no key has P = 0 and dQ = 0.
// No score tile is staged in shared memory.  Each consumer warpgroup skips
// the tile pairs that hold no kept pair of its own rows.  Every output
// element is written by exactly one thread, summed in a fixed order: no
// atomics, so gradients repeat bit for bit.  The softmax scale is folded
// into q by the caller, so the kernels see scale 1 and autograd through
// the pre-scale restores it on dq, as attention.py:1037-1042 does.

#include <math.h>
#include <string.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 256;  // two consumer warpgroups

// the forward's mask for one pair (rows past tq and keys past tk dropped)
__device__ __forceinline__ bool kept(int qrow, int key, int len, int tq, int tk, int causal, int window) {
    bool ok = qrow < tq && key < len && key < tk;
    if (causal) ok = ok && key <= qrow && (window <= 0 || key > qrow - window);
    return ok;
}

// every pair of rows [q0, q0 + nq) x keys [k0, k0 + nk) kept
__device__ __forceinline__ bool clean_pairs(int q0, int nq, int k0, int nk, int len, int tq, int tk, int causal,
                                            int window) {
    bool clean = k0 + nk <= len && k0 + nk <= tk && q0 + nq <= tq;
    if (causal) clean = clean && k0 + nk - 1 <= q0 && (window <= 0 || q0 + nq - 1 - k0 < window);
    return clean;
}

template <int HD, int BIAS>
struct Dkdv {
    static constexpr int BKB = 128, BQ = 64, STAGES = 2, SWB = HD >= 64 ? 128 : 64;
    static constexpr uint32_t KV_BYTES = BKB * HD * 2;  // the block's K (and V)
    static constexpr uint32_t T_BYTES = BQ * HD * 2;    // a Q (or dO) tile
    static constexpr uint32_t R_BYTES = BQ * 4;         // an lse (or dd) vector
    static constexpr uint32_t BIAS_BYTES = BIAS == 1 ? BQ * BKB * 4 : 0;
    static constexpr uint32_t TX_BYTES = 2 * T_BYTES + 2 * R_BYTES + BIAS_BYTES;
    // a stage: Q, dO, the bias tile, then lse and dd in the last 1 KB
    static constexpr uint32_t STAGE_BYTES = 2 * T_BYTES + BIAS_BYTES + 1024;
    static constexpr uint32_t K_OFF = 0, V_OFF = KV_BYTES, ST_OFF = 2 * KV_BYTES,
                              BAR_OFF = ST_OFF + STAGES * STAGE_BYTES;
    static constexpr uint32_t SMEM = BAR_OFF + 8 * (1 + STAGES) + 4 * STAGES;
};

template <int HD, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_dd,
                      const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ bias,
                      const int* __restrict__ kv_lens, int n_heads, int tq, int tk, int causal, int window,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
    using L = Dkdv<HD, BIAS>;
    constexpr int BKB = L::BKB, BQ = L::BQ, SWB = L::SWB, S = L::STAGES;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
    uint64_t* full = kv_full + 1;
    uint32_t* released = reinterpret_cast<uint32_t*>(full + S);

    const int bh = blockIdx.x, h = bh % n_heads, k0 = blockIdx.y * BKB;
    const int len = kv_lens[bh];
    int lo, hi;
    query_tile_range(k0, BKB, BQ, tq, tk, len, causal, window, lo, hi);
    const int n_tiles = hi - lo + 1;

    // the loads of the n-th visited query tile into its stage
    auto issue = [&](int n) {
        const int i = lo + n, s = n % S;
        unsigned char* st = smem + L::ST_OFF + s * L::STAGE_BYTES;
        mbar_expect_tx(&full[s], L::TX_BYTES);
        tma_tile<HD, SWB>(st, &tm_q, &full[s], BQ, i * BQ, bh);
        tma_tile<HD, SWB>(st + L::T_BYTES, &tm_do, &full[s], BQ, i * BQ, bh);
        unsigned char* sr = st + 2 * L::T_BYTES + L::BIAS_BYTES;
        tma_load_1d(sr, &tm_lse, &full[s], bh * f32_pitch(tq) + i * BQ);
        tma_load_1d(sr + L::R_BYTES, &tm_dd, &full[s], bh * f32_pitch(tq) + i * BQ);
        if (BIAS == 1)
            for (int p = 0; p < BKB / 32; ++p)
                tma_load_3d(st + 2 * L::T_BYTES + p * BQ * 128, &tm_b, &full[s], k0 + 32 * p, i * BQ, h);
    };

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            released[s] = 0;
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0 && n_tiles > 0) {
        mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
        tma_tile<HD, SWB>(smem + L::K_OFF, &tm_k, kv_full, BKB, k0, bh);
        tma_tile<HD, SWB>(smem + L::V_OFF, &tm_v, kv_full, BKB, k0, bh);
        for (int n = 0; n < S && n < n_tiles; ++n) issue(n);
    }
    __syncwarp();
    {
        const int cw = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        const int kw0 = k0 + 64 * cw;                   // this warpgroup's first key
        const int ka = kw0 + warp * 16 + (lane >> 2);   // this thread's keys: ka, ka + 8
        const int cq = 2 * (lane & 3);
        int wlo, whi;
        query_tile_range(kw0, 64, BQ, tq, tk, len, causal, window, wlo, whi);
        float kbias[2] = {0.f, 0.f};  // the key-only bias of this thread's keys
        if (BIAS == 2) {
            const int ldb = f32_pitch(tk);
#pragma unroll
            for (int i = 0; i < 2; ++i) kbias[i] = ka + 8 * i < tk ? bias[(size_t)h * ldb + ka + 8 * i] : 0.f;
        }

        float acc_dk[HD / 2], acc_dv[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

        if (lo <= hi) mbar_wait(kv_full, 0);
        for (int it = lo; it <= hi; ++it) {
            const int n = it - lo, s = n % S;
            const unsigned char* sQ = smem + L::ST_OFF + s * L::STAGE_BYTES;
            const unsigned char* sDO = sQ + L::T_BYTES;
            const float* sB = reinterpret_cast<const float*>(sQ + 2 * L::T_BYTES);
            const float* sL = reinterpret_cast<const float*>(sQ + 2 * L::T_BYTES + L::BIAS_BYTES);
            const float* sD = sL + BQ;
            mbar_wait(&full[s], (n / S) & 1);
            if (it >= wlo && it <= whi) {
                // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys
                float acc_s[BQ / 2], acc_dp[BQ / 2];
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk)
                    wgmma_ss<BQ>(acc_s, desc_k<HD, SWB>(smem + L::K_OFF, BKB, 64 * cw, kk),
                                 desc_k<HD, SWB>(sQ, BQ, 0, kk), kk > 0);
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk)
                    wgmma_ss<BQ>(acc_dp, desc_k<HD, SWB>(smem + L::V_OFF, BKB, 64 * cw, kk),
                                 desc_k<HD, SWB>(sDO, BQ, 0, kk), kk > 0);
                wg_commit();
                wg_wait<0>();
                fence_regs(acc_s);
                fence_regs(acc_dp);

                // P^T and dS^T in place: rows are keys, columns queries
                const int q0 = it * BQ;
                const bool clean = clean_pairs(q0, BQ, kw0, 64, len, tq, tk, causal, window);
#pragma unroll
                for (int j = 0; j < BQ / 8; ++j) {
                    const int c = 8 * j + cq;
                    const float2 lse2 = *reinterpret_cast<const float2*>(sL + c);
                    const float2 dd2 = *reinterpret_cast<const float2*>(sD + c);
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int key = ka + 8 * i;
#pragma unroll
                        for (int u = 0; u < 2; ++u) {
                            const int e = 4 * j + 2 * i + u;
                            float x = acc_s[e];
                            if (BIAS == 2) x += kbias[i];
                            if (BIAS == 1) x += f32_tile_at(sB, BQ, c + u, key - k0);
                            const bool keep = clean || kept(q0 + c + u, key, len, tq, tk, causal, window);
                            const float p = keep ? __expf(x - (u ? lse2.y : lse2.x)) : 0.f;
                            acc_dp[e] = p * (acc_dp[e] - (u ? dd2.y : dd2.x));
                            acc_s[e] = p;
                        }
                    }
                }

                // dV += P^T dO, dK += dS^T Q, A operands from registers
                uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
                pack_a<BQ>(acc_s, pa);
                pack_a<BQ>(acc_dp, dsa);
                fence_regs(acc_dv);
                fence_regs(acc_dk);
                fence_regs(pa);
                fence_regs(dsa);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<HD>(acc_dv, pa[kk], desc_mn<HD, SWB>(sDO, BQ, kk));
#pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<HD>(acc_dk, dsa[kk], desc_mn<HD, SWB>(sQ, BQ, kk));
                wg_commit();
                wg_wait<0>();
                fence_regs(acc_dv);
                fence_regs(acc_dk);
                fence_regs(pa);
                fence_regs(dsa);
            }
            release_stage(&released[s], cw, [&] {
                if (n + S < n_tiles) issue(n + S);
            });
        }
        store_rows<HD>(acc_dk, dk + (size_t)bh * tk * HD, kw0, tk, 1.f, 1.f);
        store_rows<HD>(acc_dv, dv + (size_t)bh * tk * HD, kw0, tk, 1.f, 1.f);
    }
}

template <int HD, int BIAS>
struct Dq {
    static constexpr int BQ = 128, BK = 64, STAGES = 2, SWB = HD >= 64 ? 128 : 64;
    static constexpr uint32_t Q_BYTES = BQ * HD * 2, KV_BYTES = BK * HD * 2;
    static constexpr uint32_t BIAS_BYTES = BIAS == 1 ? BQ * BK * 4 : BIAS == 2 ? BK * 4 : 0;
    static constexpr uint32_t BIAS_SLOT = (BIAS_BYTES + 1023) / 1024 * 1024;
    static constexpr uint32_t Q_OFF = 0, DO_OFF = Q_BYTES, K_OFF = 2 * Q_BYTES, V_OFF = K_OFF + STAGES * KV_BYTES,
                              B_OFF = V_OFF + STAGES * KV_BYTES, BAR_OFF = B_OFF + STAGES * BIAS_SLOT;
    static constexpr uint32_t SMEM = BAR_OFF + 8 * (1 + STAGES) + 4 * STAGES;
};

template <int HD, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ lse,
                    const float* __restrict__ dd, const int* __restrict__ kv_lens, int n_heads, int tq, int tk,
                    int causal, int window, __nv_bfloat16* __restrict__ dq) {
    using L = Dq<HD, BIAS>;
    constexpr int BQ = L::BQ, BK = L::BK, SWB = L::SWB, S = L::STAGES;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
    uint64_t* full = q_full + 1;
    uint32_t* released = reinterpret_cast<uint32_t*>(full + S);

    const int bh = blockIdx.x, h = bh % n_heads;
    const int nq = cdiv(tq, BQ);
    const int q0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
    const int len = kv_lens[bh];
    int lo, hi;
    key_tile_range(q0, BQ, BK, tq, tk, len, causal, window, false, lo, hi);
    const int n_tiles = hi - lo + 1;

    // the loads of the n-th visited key tile into its stage
    auto issue = [&](int n) {
        const int t = lo + n, s = n % S;
        mbar_expect_tx(&full[s], 2 * L::KV_BYTES + L::BIAS_BYTES);
        tma_tile<HD, SWB>(smem + L::K_OFF + s * L::KV_BYTES, &tm_k, &full[s], BK, t * BK, bh);
        tma_tile<HD, SWB>(smem + L::V_OFF + s * L::KV_BYTES, &tm_v, &full[s], BK, t * BK, bh);
        unsigned char* sb = smem + L::B_OFF + s * L::BIAS_SLOT;
        if (BIAS == 1)
            for (int p = 0; p < BK / 32; ++p) tma_load_3d(sb + p * BQ * 128, &tm_b, &full[s], t * BK + 32 * p, q0, h);
        if (BIAS == 2) tma_load_1d(sb, &tm_b, &full[s], h * f32_pitch(tk) + t * BK);
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
    if (threadIdx.x == 0 && n_tiles > 0) {
        mbar_expect_tx(q_full, 2 * L::Q_BYTES);
        tma_tile<HD, SWB>(smem + L::Q_OFF, &tm_q, q_full, BQ, q0, bh);
        tma_tile<HD, SWB>(smem + L::DO_OFF, &tm_do, q_full, BQ, q0, bh);
        for (int n = 0; n < S && n < n_tiles; ++n) issue(n);
    }
    __syncwarp();
    {
        const int cw = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        const int qw0 = q0 + 64 * cw;
        const int ra = qw0 + warp * 16 + (lane >> 2);  // this thread's rows: ra, ra + 8
        const int cq = 2 * (lane & 3);
        int wlo, whi;
        key_tile_range(qw0, 64, BK, tq, tk, len, causal, window, false, wlo, whi);
        float lse_r[2], dd_r[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = ra + 8 * i;
            lse_r[i] = row < tq ? lse[(size_t)bh * f32_pitch(tq) + row] : 0.f;
            dd_r[i] = row < tq ? dd[(size_t)bh * f32_pitch(tq) + row] : 0.f;
        }

        float acc_dq[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc_dq[i] = 0.f;
        if (lo <= hi) mbar_wait(q_full, 0);
        for (int t = lo; t <= hi; ++t) {
            const int n = t - lo, s = n % S;
            mbar_wait(&full[s], (n / S) & 1);
            if (t >= wlo && t <= whi) {
                const unsigned char* sK = smem + L::K_OFF + s * L::KV_BYTES;
                const unsigned char* sV = smem + L::V_OFF + s * L::KV_BYTES;
                const float* sB = reinterpret_cast<const float*>(smem + L::B_OFF + s * L::BIAS_SLOT);
                // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows
                float acc_s[BK / 2], acc_dp[BK / 2];
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk)
                    wgmma_ss<BK>(acc_s, desc_k<HD, SWB>(smem + L::Q_OFF, BQ, 64 * cw, kk), desc_k<HD, SWB>(sK, BK, 0, kk),
                                 kk > 0);
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk)
                    wgmma_ss<BK>(acc_dp, desc_k<HD, SWB>(smem + L::DO_OFF, BQ, 64 * cw, kk),
                                 desc_k<HD, SWB>(sV, BK, 0, kk), kk > 0);
                wg_commit();
                wg_wait<0>();
                fence_regs(acc_s);
                fence_regs(acc_dp);

                const int k0 = t * BK;
                const bool clean = clean_pairs(qw0, 64, k0, BK, len, tq, tk, causal, window);
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    const int c = 8 * j + cq;
                    float2 kb = make_float2(0.f, 0.f);
                    if (BIAS == 2) kb = *reinterpret_cast<const float2*>(sB + c);
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int row = ra + 8 * i;
#pragma unroll
                        for (int u = 0; u < 2; ++u) {
                            const int e = 4 * j + 2 * i + u;
                            float x = acc_s[e];
                            if (BIAS == 2) x += u ? kb.y : kb.x;
                            if (BIAS == 1) x += f32_tile_at(sB, BQ, row - q0, c + u);
                            const bool keep = clean || kept(row, k0 + c + u, len, tq, tk, causal, window);
                            const float p = keep ? __expf(x - lse_r[i]) : 0.f;
                            acc_dp[e] = p * (acc_dp[e] - dd_r[i]);
                        }
                    }
                }

                // dQ += dS K, dS from registers, K as the MN-major B operand
                uint32_t dsa[BK / 16][4];
                pack_a<BK>(acc_dp, dsa);
                fence_regs(acc_dq);
                fence_regs(dsa);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<HD>(acc_dq, dsa[kk], desc_mn<HD, SWB>(sK, BK, kk));
                wg_commit();
                wg_wait<0>();
                fence_regs(acc_dq);
                fence_regs(dsa);
            }
            release_stage(&released[s], cw, [&] {
                if (n + S < n_tiles) issue(n + S);
            });
        }
        store_rows<HD>(acc_dq, dq + (size_t)bh * tq * HD, qw0, tq, 1.f, 1.f);
    }
}

struct Args {
    const void *q, *k, *v, *dout;
    const float *lse, *dd, *bias;
    const int* lens;
    int bias_rows, bh, n_heads, tq, tk, causal, window;
};

template <int HD, int BIAS>
int launch_dkdv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
    using L = Dkdv<HD, BIAS>;
    CUtensorMap mq, mk, mv, mdo, ml, md, mb;
    memset(&mb, 0, sizeof(mb));
    const int ldb = f32_pitch(a.tk);
    bool ok = map_bf16_tiles(&mq, a.q, a.bh, a.tq, HD, L::BQ) && map_bf16_tiles(&mk, a.k, a.bh, a.tk, HD, L::BKB) &&
              map_bf16_tiles(&mv, a.v, a.bh, a.tk, HD, L::BKB) && map_bf16_tiles(&mdo, a.dout, a.bh, a.tq, HD, L::BQ) &&
              map_f32_vector(&ml, a.lse, (uint64_t)a.bh * f32_pitch(a.tq), L::BQ) &&
              map_f32_vector(&md, a.dd, (uint64_t)a.bh * f32_pitch(a.tq), L::BQ);
    if (BIAS == 1) ok = ok && map_f32_tiles(&mb, a.bias, a.n_heads, a.tq, ldb, L::BQ);
    if (!ok) return (int)cudaErrorInvalidValue;
    auto kern = flash_bwd_dkdv_kernel<HD, BIAS>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (err != cudaSuccess) return (int)err;
    const float* bias = a.bias;
    const int* lens = a.lens;
    int n_heads = a.n_heads, tq = a.tq, tk = a.tk, causal = a.causal, window = a.window;
    void* args[] = {&mq, &mk, &mv, &mdo, &ml, &md, &mb, &bias, &lens, &n_heads, &tq, &tk, &causal, &window, &dk, &dv};
    return (int)cudaLaunchKernel((const void*)kern, dim3(a.bh, cdiv(a.tk, L::BKB)), dim3(THREADS), args, L::SMEM,
                                 stream);
}

template <int HD, int BIAS>
int launch_dq(const Args& a, void* dq, cudaStream_t stream) {
    using L = Dq<HD, BIAS>;
    CUtensorMap mq, mk, mv, mdo, mb;
    memset(&mb, 0, sizeof(mb));
    const int ldb = f32_pitch(a.tk);
    bool ok = map_bf16_tiles(&mq, a.q, a.bh, a.tq, HD, L::BQ) && map_bf16_tiles(&mk, a.k, a.bh, a.tk, HD, L::BK) &&
              map_bf16_tiles(&mv, a.v, a.bh, a.tk, HD, L::BK) && map_bf16_tiles(&mdo, a.dout, a.bh, a.tq, HD, L::BQ);
    if (BIAS == 1) ok = ok && map_f32_tiles(&mb, a.bias, a.n_heads, a.tq, ldb, L::BQ);
    if (BIAS == 2) ok = ok && map_f32_vector(&mb, a.bias, (uint64_t)a.n_heads * ldb, L::BK);
    if (!ok) return (int)cudaErrorInvalidValue;
    auto kern = flash_bwd_dq_kernel<HD, BIAS>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (err != cudaSuccess) return (int)err;
    const float *lse = a.lse, *dd = a.dd;
    const int* lens = a.lens;
    int n_heads = a.n_heads, tq = a.tq, tk = a.tk, causal = a.causal, window = a.window;
    void* args[] = {&mq, &mk, &mv, &mdo, &mb, &lse, &dd, &lens, &n_heads, &tq, &tk, &causal, &window, &dq};
    return (int)cudaLaunchKernel((const void*)kern, dim3(a.bh, cdiv(a.tq, L::BQ)), dim3(THREADS), args, L::SMEM,
                                 stream);
}

template <typename Kern>
int kernel_info(Kern kern, int smem, int* out) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, (const void*)kern);
    int blocks = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = smem;
    out[2] = blocks;
    out[3] = (int)attr.localSizeBytes;
    return 0;
}

template <int HD, int BIAS>
int info(int which, int* out) {
    if (which == 0) return kernel_info(flash_bwd_dkdv_kernel<HD, BIAS>, (int)Dkdv<HD, BIAS>::SMEM, out);
    return kernel_info(flash_bwd_dq_kernel<HD, BIAS>, (int)Dq<HD, BIAS>::SMEM, out);
}

// bias kind: 0 none, 1 full (H, Tq, Tk), 2 key-only (H, 1, Tk)
int bias_kind(const Args& a) { return a.bias == nullptr ? 0 : a.bias_rows == 1 ? 2 : 1; }

template <int HD>
int run(const Args& a, void* dq, void* dk, void* dv, cudaStream_t st) {
    const int kind = bias_kind(a);
    if (dq != nullptr) {
        if (kind == 0) return launch_dq<HD, 0>(a, dq, st);
        if (kind == 1) return launch_dq<HD, 1>(a, dq, st);
        return launch_dq<HD, 2>(a, dq, st);
    }
    if (kind == 0) return launch_dkdv<HD, 0>(a, dk, dv, st);
    if (kind == 1) return launch_dkdv<HD, 1>(a, dk, dv, st);
    return launch_dkdv<HD, 2>(a, dk, dv, st);
}

int dispatch(const Args& a, int hd, void* dq, void* dk, void* dv, void* stream) {
    if (a.bh < 1 || a.n_heads < 1 || a.tq < 1 || a.tk < 1 || a.window < 0 || (a.window > 0 && !a.causal))
        return (int)cudaErrorInvalidValue;
    if (a.bias != nullptr && a.bias_rows != a.tq && a.bias_rows != 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32: return run<32>(a, dq, dk, dv, st);
        case 64: return run<64>(a, dq, dk, dv, st);
        case 128: return run<128>(a, dq, dk, dv, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q, dout (bh, tq, hd) and k, v (bh, tk, hd) bf16, 16-byte aligned; lse, dd
// (bh, ldq) f32 with ldq = tq rounded up to a multiple of 4; kv_lens (bh,) int32; bias (n_heads, bias_rows, ldb) f32 with
// bias_rows = tq or 1 and ldb = tk rounded up to a multiple of 4, or null;
// causal 0/1; window 0 or > 0 (causal only); dk, dv (bh, tk, hd) bf16.
int vqa_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* dd, const void* kv_lens, const void* bias, int bias_rows, int bh, int n_heads,
                       int tq, int tk, int hd, int causal, int window, void* dk, void* dv, void* stream) {
    const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dd),
                 static_cast<const float*>(bias), static_cast<const int*>(kv_lens), bias_rows, bh, n_heads, tq, tk,
                 causal, window};
    return dispatch(a, hd, nullptr, dk, dv, stream);
}

// the same inputs; dq (bh, tq, hd) bf16
int vqa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                     const void* kv_lens, const void* bias, int bias_rows, int bh, int n_heads, int tq, int tk,
                     int hd, int causal, int window, void* dq, void* stream) {
    const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dd),
                 static_cast<const float*>(bias), static_cast<const int*>(kv_lens), bias_rows, bh, n_heads, tq, tk,
                 causal, window};
    return dispatch(a, hd, dq, nullptr, nullptr, stream);
}

// out[4] = registers a thread, dynamic shared memory, blocks per SM and local
// bytes a thread (spills) of kernel `which` (0 dK/dV, 1 dQ) for head dim hd
// and bias kind 0 none / 1 full / 2 key-only
int vqa_flash_bwd_info(int hd, int bias, int which, int* out) {
    switch (hd * 4 + bias) {
        case 32 * 4 + 0: return info<32, 0>(which, out);
        case 32 * 4 + 1: return info<32, 1>(which, out);
        case 32 * 4 + 2: return info<32, 2>(which, out);
        case 64 * 4 + 0: return info<64, 0>(which, out);
        case 64 * 4 + 1: return info<64, 1>(which, out);
        case 64 * 4 + 2: return info<64, 2>(which, out);
        case 128 * 4 + 0: return info<128, 0>(which, out);
        case 128 * 4 + 1: return info<128, 1>(which, out);
        case 128 * 4 + 2: return info<128, 2>(which, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
