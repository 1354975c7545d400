// IVF probe-score scan (kernel K5) for Hopper (sm_90a):
//     for each query b and probe p, with c = probe_ids[b, p]:
//         s[b, p, r] = (sum_d bf16(q[b, d]) * codes[c, r, d]) * scales[c, r]
//         s[b, p, r] = -inf where gids[c, r] < 0;   g[b, p, r] = gids[c, r]
//
// Replaces the Pallas kernel vietnamese_qa_system_tpu/ops/ivf_probe.py
// `_probe_score_kernel` (via `ivf_probe_scores`).  Same arithmetic: the
// query row is rounded to bf16, int8 or bf16 codes are widened (exactly),
// each product of two such values is exact in f32, the products are summed
// in f32 over D, and the per-row scale (when given) multiplies once, after
// the sum.  Only the order of the f32 additions differs from the TPU (and
// from the plain version): lane partial sums over the lane's 16-byte
// vectors, then a butterfly of warp shuffles, in a fixed order, so a
// result repeats bit for bit.  The TPU's padding of P to 8 and its scalar
// prefetch of the probe ids are layout, not semantics: here a block loads
// its own probe id.
//
// What bounds it on an H100: two operations per code byte (bf16) or per
// two code bytes (int8), far below the card's ~295 operations per byte, so
// the bytes: the distinct probed slabs (codes, scales, gids), the queries
// and the (B, P, cap) scores and gids.  At B = 1, P = 8, cap = 512, D = 768
// in bf16 that is ~6.3 MB, ~1.9 us at 3.35 TB/s, so a launch costs more than
// the scan; at B = 32 it is ~0.2 GB.  The design spreads even one query over
// the card: a block scores 32 rows of one bucket, so B = 1 launches
// 8 x 16 = 128 blocks for 132 SMs.  Each warp owns 8 consecutive rows and
// scores 4 of them at a time, the loads of all 4 in flight before any is used,
// neighbouring lanes on neighbouring 16-byte vectors.  The query row sits
// in shared memory as f32.  int8 codes become f32 by a byte permute and one
// f32 subtraction (2^23 + 128 + code is exact in f32).
//
// Deliberately simple: queries that probe the same cluster each re-read its
// slab (from L2 when they share a launch), and there is no cp.async / TMA
// ring.  Grouping such queries into one tensor-core tile is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;                  // bucket rows a block
constexpr int ROWS_PER_WARP = ROWS / WARPS;
constexpr int UNROLL = 4;                 // rows a warp scores at once
constexpr int MAX_SMEM = 48 * 1024;       // the query row, D f32

// dot of one 16-byte vector of codes with its query values (f32, in smem)
__device__ __forceinline__ float dot_vec_bf16(const uint4& raw, const float* qv, float acc) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        acc = fmaf(qv[2 * i], __uint_as_float(w[i] << 16), acc);
        acc = fmaf(qv[2 * i + 1], __uint_as_float(w[i] & 0xFFFF0000u), acc);
    }
    return acc;
}

__device__ __forceinline__ float dot_vec_int8(const uint4& raw, const float* qv, float acc) {
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float c = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440 | j)) - 8388736.f;
            acc = fmaf(qv[4 * i + j], c, acc);
        }
    }
    return acc;
}

// grid (B * P, cap / ROWS); dynamic shared memory: D f32
template <bool INT8>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ q, const int* __restrict__ probe_ids, const void* __restrict__ buckets,
             const float* __restrict__ scales, const int* __restrict__ gids, int P, int C, int cap, int D,
             float* __restrict__ out_s, int* __restrict__ out_g) {
    extern __shared__ __align__(16) float qs[];
    __shared__ float row_s[ROWS];
    constexpr int V = INT8 ? 16 : 8;      // codes per 16-byte vector
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bp = blockIdx.x, b = bp / P;
    const int r0 = blockIdx.y * ROWS;
    const int c = probe_ids[bp];
    float* os = out_s + (size_t)bp * cap + r0;
    int* og = out_g + (size_t)bp * cap + r0;
    if (c < 0 || c >= C) {                 // no bucket to read: nothing scores
        if (tid < ROWS) {
            os[tid] = -INFINITY;
            og[tid] = -1;
        }
        return;
    }
    for (int i = tid; i < D; i += THREADS) qs[i] = __bfloat162float(__float2bfloat16_rn(q[(size_t)b * D + i]));
    __syncthreads();

    const int vecs = D / V;
    const size_t row_bytes = (size_t)D * (INT8 ? 1 : 2);
    const char* base = static_cast<const char*>(buckets) + ((size_t)c * cap + r0) * row_bytes;
    for (int rw = warp * ROWS_PER_WARP; rw < (warp + 1) * ROWS_PER_WARP; rw += UNROLL) {
        float acc[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[u] = 0.f;
        for (int v = lane; v < vecs; v += 32) {
            uint4 raw[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                raw[u] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(rw + u) * row_bytes) + v);
            const float* qv = qs + v * V;
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                acc[u] = INT8 ? dot_vec_int8(raw[u], qv, acc[u]) : dot_vec_bf16(raw[u], qv, acc[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
        }
        if (lane == 0) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) row_s[rw + u] = acc[u];
        }
    }
    __syncthreads();
    if (tid < ROWS) {
        const size_t at = (size_t)c * cap + r0 + tid;
        const int g = gids[at];
        float s = row_s[tid];
        if (scales != nullptr) s *= scales[at];
        os[tid] = g < 0 ? -INFINITY : s;
        og[tid] = g;
    }
}

}  // namespace

extern "C" {

// q (B, D) f32 (a global int8 scale already folded in); probe_ids (B, P)
// int32; buckets (C, cap, D) int8 (is_int8) or bf16, 16-byte aligned;
// scales (C, cap) f32 or null; gids (C, cap) int32; out_s (B, P, cap) f32,
// out_g (B, P, cap) int32.  cap % 32 == 0; D a multiple of the codes in 16
// bytes (16 int8, 8 bf16).  A probe id outside [0, C) scores -inf, gid -1.
int vqa_ivf_probe(const void* q, const void* probe_ids, const void* buckets, const void* scales, const void* gids,
                  int is_int8, int B, int P, int C, int cap, int D, void* out_s, void* out_g, void* stream) {
    const int V = is_int8 ? 16 : 8;
    if (B < 1 || P < 1 || C < 1 || cap < ROWS || cap % ROWS != 0 || cap / ROWS > 65535 || D < V || D % V != 0 ||
        (size_t)(D + ROWS) * sizeof(float) > MAX_SMEM || (long long)B * P > 0x7fffffffLL ||
        reinterpret_cast<uintptr_t>(buckets) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)(B * P), (unsigned)(cap / ROWS));
    const size_t smem = (size_t)D * sizeof(float);
    const auto* qf = static_cast<const float*>(q);
    const auto* ids = static_cast<const int*>(probe_ids);
    const auto* sc = static_cast<const float*>(scales);
    const auto* g = static_cast<const int*>(gids);
    auto* os = static_cast<float*>(out_s);
    auto* og = static_cast<int*>(out_g);
    if (is_int8)
        probe_kernel<true><<<grid, THREADS, smem, st>>>(qf, ids, buckets, sc, g, P, C, cap, D, os, og);
    else
        probe_kernel<false><<<grid, THREADS, smem, st>>>(qf, ids, buckets, sc, g, P, C, cap, D, os, og);
    return (int)cudaGetLastError();
}

}  // extern "C"
