// Weight-only int8 GEMM (the w8 GEMM) for Hopper (sm_90a):
//     y[M, N] = (bf16(x)[M, K] @ w_q[K, N]) * w_s[N]      (f32 out)
//
// Replaces the Pallas kernel vietnamese_qa_system_tpu/ops/w8_matmul.py
// `_w8_kernel` (via `_w8_matmul`), which the causal LM's dense layers call
// on int8c weights (one scale per output column) whenever the rows fit
// (models/layers.py `dense`: rows <= 256, K and N divisible by 128).
// Same arithmetic: each int8 code is exact in bf16, each product of two
// bf16 values is exact in f32, the products are summed in f32 over all of
// K, and the column scale multiplies once, after the whole K sum.
//
// What bounds it on an H100: at decode shapes (M = the batch, 1..16) the
// product is a skinny GEMM of ~2*M operations per weight byte, far below
// the ~295 bf16 operations per byte where the tensor cores become the
// limit, so the int8 weight bytes over HBM bandwidth are the bound
// (3072 x 12288 = 37.7 MB -> ~11 us at 3.35 TB/s).  The design streams
// every weight byte once, coalesced, with enough blocks and loads in
// flight to cover the card, and keeps the per-byte instruction count low
// enough that it never becomes the limit: the products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate; M is padded to 16
// rows, whose cost is nil next to the weight stream), and an int8 code
// becomes bf16 by a byte permute and one f32 subtraction (2^23 + 128 + b
// is exact in f32) instead of the quarter-rate int-to-float conversion.
//
// Design:
// - A block of 8 warps owns 64 output columns, a chunk of K rows (kc, a
//   multiple of 128, at most 1024) and a tile of 16 rows of x.  Two warps
//   share the 64 columns (32 each, as four 8-column mma tiles) and four
//   warps split the chunk's 16-row steps between them.
// - A thread's B fragments for the four tiles come from four 32-bit loads
//   (rows 2t, 2t+1, 2t+8, 2t+9 of the step; 4 adjacent columns): tile i's
//   logical column g is physical column 4g + i of the warp's 32, so each
//   load of a warp reads whole 32-byte sectors.  Four steps are loaded
//   before any is used, and the block asks for at most 128 registers a
//   thread so that two blocks share an SM (on an H100 this beat
//   double-buffering the loads in one block a SM at every decode shape).
// - The x tile [16, kc] is staged once into shared memory as bf16 with a
//   row stride of kc + 8 elements (A fragments read conflict-free).
// - Too few blocks is the first trap at decode: 3072 columns give only 48
//   column tiles for 132 SMs, so K is split across blocks (grid y) until
//   there are about two blocks per SM.  Each block adds its four K-lane
//   warps through shared memory in a fixed order; the splits then land in
//   an f32 workspace and a second pass adds them in split order and
//   applies the scale.  No float atomics anywhere, so a result repeats bit
//   for bit on the same card.  With one split the first pass applies the
//   scale and writes y itself.  M > 16 runs more row tiles (grid z).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NT = 64;                  // columns per block
constexpr int GROUP = 32;               // columns per warp (four n8 tiles)
constexpr int KLANES = WARPS / (NT / GROUP);  // warps splitting a chunk's steps
constexpr int MT = 16;                  // rows of x per block (the mma's M)
constexpr int UNROLL = 4;               // 16-row steps loaded before use
constexpr int KC_MAX = 1024;
constexpr int KC_STEP = 128;
constexpr int SMEM_BYTES = MT * (KC_MAX + 8) * 2;  // x tile; reused for the [WARPS][16][32] f32 reduction
static_assert(WARPS * MT * GROUP * 4 <= SMEM_BYTES, "reduction buffer fits the x tile");

__device__ __forceinline__ uint32_t ldg_stream(const int8_t* p) {
    return __ldcs(reinterpret_cast<const unsigned int*>(p));
}

// byte i of `lo` and of `hi` (int8 codes) -> one register of two bf16,
// lo in the low half: 0x4B0000uu is 2^23 + u as f32, u = code + 128
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi, int i) {
    const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 | i)) - 8388736.f;
    const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 | i)) - 8388736.f;
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (N / 64, splits, ceil(M / 16)).  `direct`: one split, so the scale
// is applied here and `out` is y (M, N); otherwise `out` is the
// (splits, M, N) workspace of unscaled partial sums.
__global__ void __launch_bounds__(THREADS, 2)
w8_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ ws,
               int M, int K, int N, int kc, float* __restrict__ out, int direct) {
    __shared__ __align__(16) unsigned char smem[SMEM_BYTES];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;        // mma fragment coordinates
    const int grp = warp % (NT / GROUP), klane = warp / (NT / GROUP);
    const int col0 = blockIdx.x * NT;
    const int k0 = blockIdx.y * kc;
    const int rows = min(K, k0 + kc) - k0;        // a multiple of 128
    const int m0 = blockIdx.z * MT;
    const int xs_ld = rows + 8;                   // (rows + 8) / 2 words = 4 mod 32: conflict-free A reads

    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    const int vpr = rows / 8;                     // 16-byte vectors per x row
    for (int idx = tid; idx < MT * vpr; idx += THREADS) {
        const int r = idx / vpr, v = idx - r * vpr;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + v * 8);
        *reinterpret_cast<uint4*>(xs + r * xs_ld + v * 8) = val;
    }
    __syncthreads();

    float c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = 0.f;

    const int steps = rows / 16;
    const int8_t* wbase = wq + (size_t)(k0 + 2 * t) * N + col0 + grp * GROUP + 4 * g;
    for (int s0 = klane; s0 < steps; s0 += KLANES * UNROLL) {
        uint32_t w[UNROLL][4];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int s = s0 + u * KLANES;
            if (s < steps) {
                const int8_t* p = wbase + (size_t)s * 16 * N;
                w[u][0] = ldg_stream(p);
                w[u][1] = ldg_stream(p + N);
                w[u][2] = ldg_stream(p + 8 * (size_t)N);
                w[u][3] = ldg_stream(p + 9 * (size_t)N);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int s = s0 + u * KLANES;
            if (s < steps) {
                const __nv_bfloat16* xa = xs + g * xs_ld + s * 16 + 2 * t;
                const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xa);
                const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xa + 8 * xs_ld);
                const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xa + 8);
                const uint32_t a3 = *reinterpret_cast<const uint32_t*>(xa + 8 * xs_ld + 8);
                const uint32_t r0 = w[u][0] ^ 0x80808080u, r1 = w[u][1] ^ 0x80808080u;
                const uint32_t r8 = w[u][2] ^ 0x80808080u, r9 = w[u][3] ^ 0x80808080u;
#pragma unroll
                for (int i = 0; i < 4; ++i) mma_bf16(c[i], a0, a1, a2, a3, bf16_pair(r0, r1, i), bf16_pair(r8, r9, i));
            }
        }
    }

    __syncthreads();  // every thread is done with the x tile
    float* red = reinterpret_cast<float*>(smem);  // [WARPS][16][32]: rows x the warp's physical columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int col = 8 * t + i;  // logical columns 2t, 2t+1 of tile i are physical 8t+i, 8t+4+i
        red[(warp * MT + g) * GROUP + col] = c[i][0];
        red[(warp * MT + g) * GROUP + col + 4] = c[i][1];
        red[(warp * MT + g + 8) * GROUP + col] = c[i][2];
        red[(warp * MT + g + 8) * GROUP + col + 4] = c[i][3];
    }
    __syncthreads();
    for (int o = tid; o < MT * NT; o += THREADS) {
        const int r = o / NT, cc = o - r * NT;
        const int gr = cc / GROUP, cl = cc - gr * GROUP;
        const int gm = m0 + r, gn = col0 + cc;
        if (gm >= M) continue;
        float s = red[(gr * MT + r) * GROUP + cl];  // warp klane 0 of the group
#pragma unroll
        for (int kl = 1; kl < KLANES; ++kl) s += red[((kl * (NT / GROUP) + gr) * MT + r) * GROUP + cl];
        if (direct) out[(size_t)gm * N + gn] = s * ws[gn];
        else out[((size_t)blockIdx.y * M + gm) * N + gn] = s;
    }
}

// y[i] = (sum over splits, in split order) * w_s[column]
__global__ void w8_reduce_kernel(const float* __restrict__ part, const float* __restrict__ ws, int splits, int M,
                                 int N, float* __restrict__ y) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t mn = (size_t)M * N;
    if (i >= mn) return;
    float s = part[i];
    for (int j = 1; j < splits; ++j) s += part[(size_t)j * mn + i];
    y[i] = s * ws[i % N];
}

}  // namespace

extern "C" {

// x (M, K) bf16, 16-byte aligned; w_q (K, N) int8, row-major, 4-byte
// aligned; w_s (N,) f32; y (M, N) f32.  K and N divisible by 128; kc a
// multiple of 128 in [128, 1024] and splits == ceil(K / kc); part holds
// splits * M * N f32 when splits > 1.
int vqa_w8_matmul(const void* x, const void* wq, const void* ws, int M, int K, int N, int kc, int splits, void* part,
                  void* y, void* stream) {
    if (M < 1 || K < KC_STEP || N < 128 || K % KC_STEP != 0 || N % 128 != 0 || kc < KC_STEP || kc > KC_MAX ||
        kc % KC_STEP != 0 || splits != (K + kc - 1) / kc || (splits > 1 && part == nullptr) ||
        (M + MT - 1) / MT > 65535 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(wq) % 4 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool direct = splits == 1;
    auto* yf = static_cast<float*>(y);
    auto* pf = static_cast<float*>(part);
    const auto* s = static_cast<const float*>(ws);
    dim3 grid(N / NT, splits, (M + MT - 1) / MT);
    w8_gemm_kernel<<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq), s,
                                             M, K, N, kc, direct ? yf : pf, direct ? 1 : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || direct) return (int)err;
    const size_t mn = (size_t)M * N;
    w8_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(pf, s, splits, M, N, yf);
    return (int)cudaGetLastError();
}

}  // extern "C"
