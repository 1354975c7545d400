// Per-row symmetric int8 quantization (kernel K8) for Hopper (sm_90a):
//     scale[r] = max(max_j |x[r, j]|, 1e-12) / 127
//     q[r, j]  = clip(round_half_even(x[r, j] / scale[r]), -127, 127)
//
// Replaces the Pallas kernel vietnamese_qa_system_tpu/ops/quant.py
// `_quant_kernel` (via `_quantize_int8`).  Same arithmetic, so the codes and
// scales are bit-identical to the plain function (ops/quant.py
// `quantize_int8_reference`) for finite inputs: x in f32 (a bf16 input is
// widened exactly), the scale and every code from true IEEE divisions
// (__fdiv_rn, whatever the compiler flags), rintf rounds half to even like
// jnp.round and torch.round.  A row holding a NaN is not held to that (the
// plain function propagates it; fmaxf here drops it).
//
// What bounds it on an H100: about 1 operation per byte, so the bytes: read
// N*D*4 (f32) and write N*D + 4*N.  At 1,048,576 x 768 f32 that is 4.03 GB,
// 1.2 ms at 3.35 TB/s.  The design reads each row with 16-byte loads,
// neighbouring lanes on neighbouring bytes, one warp a row, takes the
// absmax by warp shuffles, then reads the row again (from L1/L2: a block's
// eight rows are at most 8 x D x 4 bytes) to divide, round and store the
// codes packed, four or eight to a store.  No shared memory, no atomics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };           // 16 bytes = 4 f32
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };   // 16 bytes = 8 bf16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the VEC values of one 16-byte load, widened to f32
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
}

__device__ __forceinline__ int code(float v, float scale) {
    const float r = rintf(__fdiv_rn(v, scale));
    return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// one warp a row; `vec`: the row's start is 16-byte aligned and D is a
// multiple of the vector width, so rows are read with 16-byte loads
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_kernel(const T* __restrict__ x, int N, int D, int vec, int8_t* __restrict__ q, float* __restrict__ scales) {
    constexpr int V = Vec<T>::N;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (row >= N) return;
    const T* xr = x + (size_t)row * D;
    int8_t* qr = q + (size_t)row * D;

    float amax = 0.f;
    if (vec) {
        for (int v = lane; v < D / V; v += 32) {
            float f[V];
            unpack(__ldg(reinterpret_cast<const uint4*>(xr) + v), f);
#pragma unroll
            for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(f[i]));
        }
    } else {
        for (int j = lane; j < D; j += 32) amax = fmaxf(amax, fabsf(to_f32(xr[j])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    if (lane == 0) scales[row] = scale;

    if (vec) {
        for (int v = lane; v < D / V; v += 32) {
            float f[V];
            unpack(__ldg(reinterpret_cast<const uint4*>(xr) + v), f);
            uint32_t packed[V / 4];
#pragma unroll
            for (int w = 0; w < V / 4; ++w) {
                packed[w] = 0u;
#pragma unroll
                for (int i = 0; i < 4; ++i) packed[w] |= (uint32_t)(code(f[4 * w + i], scale) & 0xFF) << (8 * i);
            }
            if constexpr (V == 4) {
                reinterpret_cast<uint32_t*>(qr)[v] = packed[0];
            } else {
                reinterpret_cast<uint2*>(qr)[v] = make_uint2(packed[0], packed[1]);
            }
        }
    } else {
        for (int j = lane; j < D; j += 32) qr[j] = (int8_t)code(to_f32(xr[j]), scale);
    }
}

}  // namespace

extern "C" {

// x (N, D) f32 (is_bf16 == 0) or bf16, row-major; q (N, D) int8; scales (N,) f32.
int vqa_quantize_int8(const void* x, int is_bf16, int N, int D, void* q, void* scales, void* stream) {
    if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
    const int width = is_bf16 ? 8 : 4;
    const int vec = D % width == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 8 == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned blocks = (unsigned)((N + WARPS - 1) / WARPS);
    auto* qo = static_cast<int8_t*>(q);
    auto* so = static_cast<float*>(scales);
    if (is_bf16)
        quant_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x), N, D, vec, qo, so);
    else
        quant_kernel<float><<<blocks, THREADS, 0, st>>>(static_cast<const float*>(x), N, D, vec, qo, so);
    return (int)cudaGetLastError();
}

}  // extern "C"
