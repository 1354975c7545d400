// Decode attention over a bf16 KV cache, read in place (kernel K9), for
// Hopper (sm_90a).  For each batch row b, query row t and head h, with
// kv head g = h / (H / kvH) and the first n_keys cache columns j:
//     l[j] = (sum_d bf16(q[b, t, h, d]) * k[b, j, g, d]) * scale + bias[b, h, t, j]
//     p    = bf16(softmax over the j with mask[b, t, j] of l)   (masked keys weigh 0)
//     out[b, t, h, :] = sum_j p[j] * v[b, j, g, :]               (f32)
// A row with no valid key gives 0.
//
// Replaces no TPU kernel: the JAX package computes cached attention with
// two einsums that XLA fuses, at
//     vietnamese_qa_system_tpu/models/layers.py:528-553
// K9 takes the port's einsum branch of Attention.forward (models/layers.py)
// wherever the cache is bf16 and a call has at most 16 query positions:
// that branch copied the first n_keys cache columns of K
// and V to f32 in every call (a strided copy of the whole slab, at every
// decode step and layer), repeated them for grouped heads, and ran the
// products over every column whatever each row's length.
//
// Same arithmetic as the einsum branch (ops/decode_attention.py
// `decode_attention_plain`): exact bf16 x bf16 products summed in f32, the
// scale and the bias applied after the sum without contraction, an f32
// softmax with the exact max and sum of the row, the probabilities rounded
// to bf16 before the product with V, that product summed in f32.  Only the
// order of the f32 additions differs.  Where a row's keys are split over
// several blocks (below), each block normalizes and rounds with its own
// max and sum and a second kernel weighs the blocks' outputs by their sums:
// each probability is then rounded against another denominator, which moves
// the output by at most 2^-8 of max |v| (two roundings of 2^-9 each).
//
// What bounds it on an H100: about 2 operations a byte of K or V for one
// query row (2 x 9 at a speculative window of 9), far below the card's ~295
// a byte, so the bytes: each valid column's K and V row read once, plus q,
// the output, the mask and the bias.  PhoGPT-4B's decode step at 32 slots
// of ~600 valid columns, 24 heads of 128: ~236 MB a layer, ~70 us at
// 3.35 TB/s.  The design:
// - one block of 128 threads a (key split, kv head, batch row): a grouped
//   head's query rows (up to 16 a block: rep x Tq rows, in blocks of <= 16
//   beyond that) share every K and V load;
// - the key tiles (64 columns) whose mask bits are all false for every
//   query row of the block are never loaded: the columns past each slot's
//   cursor and whole padding holes cost nothing, with no read-back;
// - the live tiles stream through a 3-stage cp.async ring of 16-byte
//   copies (each (key, head) row is 2 x head-dim contiguous bytes), first
//   K, then V: V's first tiles load while the softmax runs;
// - the logits of the block's rows stay in shared memory (4 bytes a row a
//   column), so the softmax takes the row's exact max and sum; the number
//   of key splits is chosen from what the call shows (batch x kv heads
//   against the card's SMs, the columns, the rows): one split at 32 slots
//   x 24 heads, several for a single-row /qa step or where the logits of
//   all columns would not fit;
// - products on CUDA cores in f32: a tensor-core tile would be mostly
//   empty at <= 16 rows, and the bytes bound it anyway.  A thread widens
//   its share of a staged K or V tile to f32 registers once and runs the
//   block's rows over it in a loop of the rows there are (no row padding);
//   the rows' partial outputs gather in shared memory.  Staged rows are
//   padded by 16 bytes, so the 16-byte shared loads of eight consecutive
//   keys fall on distinct banks.
// Measured on an H100 80GB HBM3 at 700 W: 0.094 ms at that decode step
// against its 0.061 ms bound; a speculative window of 9 rows 0.30 ms
// against 0.058 ms, where the products' instruction issue, not the bytes,
// sets the time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;          // keys a tile
constexpr int STAGES = 3;         // cp.async ring depth (2-4 measured alike)
constexpr int MAX_ROWS = 16;      // query rows a block
constexpr int BATCH = 8;          // independent global loads a thread keeps in flight
constexpr int MAX_SMEM = 227 * 1024;

struct Args {
    const __nv_bfloat16* q;       // (B, Tq, H, D) contiguous
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    const uint8_t* mask;          // bool, broadcast dims with stride 0
    const float* bias;            // or null
    float* out;                   // (B, Tq, H, D)
    float* part_o;                // (splits, B, Tq, H, D) where splits > 1
    float* part_ml;               // (splits, B, Tq, H, 2): the block's max and sum
    int B, Tq, H, kvH, n_keys;
    int mrows;                    // distinct mask rows: 1 or Tq
    int splits, per;              // key splits, tiles a split
    int row_blocks, block_rows;   // a kv head's rep x Tq query rows in blocks of block_rows
    long long ks[3], vs[3];       // element strides of b, key, kv head (the head dim is contiguous)
    long long ms[3];              // mask strides of b, t, key
    long long bs[4];              // bias strides of b, h, t, key
    float scale;
};

template <int D>
struct Geo {
    static constexpr int ROW = 2 * D + 16;     // bytes of a staged key row, padded
    static constexpr int STAGE = TILE * ROW;
    static constexpr int CHUNKS = D / 8;       // 16-byte chunks a row
    static constexpr int PAIRS = D / 2;        // output column pairs
    static constexpr int KP = THREADS / PAIRS; // key ranges of the product with V
    static constexpr int KEYS = TILE / KP;     // keys a thread takes in it
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// the cp.async copies of load i (0 .. n_live-1 the live K tiles, n_live ..
// 2 n_live-1 the V tiles) into its ring slot; rows past k1 are zero-filled
template <int D>
__device__ __forceinline__ void issue_tile(const Args& a, unsigned char* stages, const int* live, int i, int n_live,
                                           int b, int g, int k0, int k1, int tid) {
    using G = Geo<D>;
    const bool is_v = i >= n_live;
    const int j0 = k0 + live[is_v ? i - n_live : i] * TILE;
    // scalars, not a pointer into the parameter struct (which would copy it to local memory)
    const __nv_bfloat16* base = is_v ? a.v : a.k;
    const long long s_b = is_v ? a.vs[0] : a.ks[0], s_l = is_v ? a.vs[1] : a.ks[1];
    const long long s_h = is_v ? a.vs[2] : a.ks[2];
    unsigned char* dst = stages + (i % STAGES) * G::STAGE;
#pragma unroll
    for (int c = tid; c < TILE * G::CHUNKS; c += THREADS) {
        const int row = c / G::CHUNKS, col = c % G::CHUNKS;
        const int j = j0 + row;
        const bool ok = j < k1;
        const __nv_bfloat16* src = base + b * s_b + (long long)(ok ? j : k0) * s_l + g * s_h + col * 8;
        cp_async16(dst + row * G::ROW + col * 16, src, ok);
    }
}

// grid (splits, kvH x row_blocks, B)
template <int D>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const Args a) {
    using G = Geo<D>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int nr = a.block_rows, ld = a.per * TILE;
    unsigned char* stages = smem;
    float* qs = reinterpret_cast<float*>(smem + STAGES * G::STAGE);  // [nr][D]
    float* lg = qs + nr * D;                                          // [nr][ld]: logits, then probabilities
    float* acc = lg + (size_t)nr * ld;                                // [KP][nr][D]: partial outputs
    int* live = reinterpret_cast<int*>(acc + G::KP * nr * D);         // [per]
    float* row_m = reinterpret_cast<float*>(live + a.per);            // [nr]
    float* row_l = row_m + nr;                                        // [nr]
    __shared__ int n_live_s;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x;
    const int g = blockIdx.y / a.row_blocks, rb = blockIdx.y % a.row_blocks;
    const int b = blockIdx.z;
    const int rep = a.H / a.kvH;
    const int r0 = rb * nr;
    const int nrows = min(nr, rep * a.Tq - r0);
    const int k0 = split * ld;
    const int k1 = min(a.n_keys, k0 + ld);
    const int tiles = (k1 - k0 + TILE - 1) / TILE;
    const uint8_t* mask_b = a.mask + b * a.ms[0];

    // the block's query rows, row i = (head g * rep + (r0 + i) / Tq, position (r0 + i) % Tq)
    for (int e0 = tid; e0 < nrows * D; e0 += THREADS * BATCH) {
        float v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const int e = e0 + u * THREADS, r = r0 + e / D;
            v[u] = e < nrows * D ? __bfloat162float(__ldg(a.q + ((size_t)(b * a.Tq + r % a.Tq) * a.H + g * rep + r / a.Tq) * D + e % D)) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            if (e0 + u * THREADS < nrows * D) qs[e0 + u * THREADS] = v[u];
    }
    for (int i = tid; i < tiles; i += THREADS) live[i] = 0;
    for (int i = tid; i < G::KP * nr * D; i += THREADS) acc[i] = 0.f;
    if (tid < nrows) {
        row_m[tid] = -INFINITY;
        row_l[tid] = 0.f;
    }
    __syncthreads();
    // the tiles that any query row attends (the mask has no head axis): every
    // thread reads its share of the mask bytes, BATCH loads in flight
    const int span = tiles * TILE, n_mask = a.mrows * span;
    for (int e0 = tid; e0 < n_mask; e0 += THREADS * BATCH) {
        uint8_t m[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const int e = e0 + u * THREADS, j = k0 + e % span;
            m[u] = e < n_mask && j < k1 ? __ldg(mask_b + (e / span) * a.ms[1] + (long long)j * a.ms[2]) : 0;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            if (m[u]) live[((e0 + u * THREADS) % span) / TILE] = 1;
    }
    __syncthreads();
    if (tid == 0) {
        int n = 0;
        for (int i = 0; i < tiles; ++i)
            if (live[i]) live[n++] = i;
        n_live_s = n;
    }
    __syncthreads();
    const int n_live = n_live_s;
    const int width = n_live * TILE;  // the live columns of a row of lg
    for (int e = tid; e < nrows * width; e += THREADS) lg[(size_t)(e / width) * ld + e % width] = 0.f;

    const int key = tid & (TILE - 1), half = tid / TILE;     // logits: a key and half of the head dim
    const int pair = tid % G::PAIRS, kp = tid / G::PAIRS;    // product with V: a column pair, a key range
    const int n_load = 2 * n_live;
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < n_load) issue_tile<D>(a, stages, live, i, n_live, b, g, k0, k1, tid);
        cp_async_commit();  // possibly empty: one group a load index
    }
    for (int i = 0; i < n_load; ++i) {
        if (i + STAGES - 1 < n_load) issue_tile<D>(a, stages, live, i + STAGES - 1, n_live, b, g, k0, k1, tid);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // load i has landed (this thread's copies)
        __syncthreads();              // and every thread's
        const unsigned char* st = stages + (i % STAGES) * G::STAGE;
        if (i < n_live) {
            float kf[D / 2];
            const uint4* kr = reinterpret_cast<const uint4*>(st + key * G::ROW + half * D);
#pragma unroll
            for (int c = 0; c < D / 16; ++c) {
                const uint4 w = kr[c];
                kf[8 * c] = bf_lo(w.x), kf[8 * c + 1] = bf_hi(w.x), kf[8 * c + 2] = bf_lo(w.y);
                kf[8 * c + 3] = bf_hi(w.y), kf[8 * c + 4] = bf_lo(w.z), kf[8 * c + 5] = bf_hi(w.z);
                kf[8 * c + 6] = bf_lo(w.w), kf[8 * c + 7] = bf_hi(w.w);
            }
            float* out = lg + i * TILE + key;
            for (int r = 0; r < nrows; ++r) {
                const float4* q4 = reinterpret_cast<const float4*>(qs + r * D + half * (D / 2));
                float s = 0.f;
#pragma unroll
                for (int c = 0; c < D / 8; ++c) {
                    const float4 qv = q4[c];
                    s = fmaf(qv.x, kf[4 * c], s);
                    s = fmaf(qv.y, kf[4 * c + 1], s);
                    s = fmaf(qv.z, kf[4 * c + 2], s);
                    s = fmaf(qv.w, kf[4 * c + 3], s);
                }
                // 0 + a + b: the same sum in either order
                atomicAdd(out + (size_t)r * ld, s);
            }
        } else {
            float v0[G::KEYS], v1[G::KEYS];
#pragma unroll
            for (int kk = 0; kk < G::KEYS; ++kk) {
                const uint32_t w = *reinterpret_cast<const uint32_t*>(st + (kp * G::KEYS + kk) * G::ROW + pair * 4);
                v0[kk] = bf_lo(w), v1[kk] = bf_hi(w);
            }
            const float* pr = lg + (i - n_live) * TILE + kp * G::KEYS;
            for (int r = 0; r < nrows; ++r) {
                const float4* p4 = reinterpret_cast<const float4*>(pr + (size_t)r * ld);
                float s0 = 0.f, s1 = 0.f;
#pragma unroll
                for (int c = 0; c < G::KEYS / 4; ++c) {
                    const float4 pv = p4[c];
                    s0 = fmaf(pv.x, v0[4 * c], s0), s1 = fmaf(pv.x, v1[4 * c], s1);
                    s0 = fmaf(pv.y, v0[4 * c + 1], s0), s1 = fmaf(pv.y, v1[4 * c + 1], s1);
                    s0 = fmaf(pv.z, v0[4 * c + 2], s0), s1 = fmaf(pv.z, v1[4 * c + 2], s1);
                    s0 = fmaf(pv.w, v0[4 * c + 3], s0), s1 = fmaf(pv.w, v1[4 * c + 3], s1);
                }
                float2* o = reinterpret_cast<float2*>(acc + (kp * nr + r) * D + 2 * pair);  // this thread's alone
                const float2 was = *o;
                *o = make_float2(was.x + s0, was.y + s1);
            }
        }
        __syncthreads();
        if (i == n_live - 1) {
            // scale, bias and mask every logit, all threads over all rows at once, BATCH mask and bias
            // reads in flight ...
            for (int e0 = tid; e0 < nrows * width; e0 += THREADS * BATCH) {
                bool keep[BATCH];
                float add[BATCH];
#pragma unroll
                for (int u = 0; u < BATCH; ++u) {
                    const int e = e0 + u * THREADS, rr = r0 + e / width, c = e % width;
                    const int h = g * rep + rr / a.Tq, t = rr % a.Tq;
                    const int j = k0 + live[c / TILE] * TILE + c % TILE;
                    keep[u] = e < nrows * width && j < k1 && __ldg(mask_b + t * a.ms[1] + (long long)j * a.ms[2]);
                    add[u] = keep[u] && a.bias != nullptr
                                 ? __ldg(a.bias + b * a.bs[0] + h * a.bs[1] + t * a.bs[2] + (long long)j * a.bs[3])
                                 : 0.f;
                }
#pragma unroll
                for (int u = 0; u < BATCH; ++u) {
                    const int e = e0 + u * THREADS;
                    if (e < nrows * width) {
                        float* l = lg + (size_t)(e / width) * ld + e % width;
                        const float x = __fmul_rn(*l, a.scale);
                        *l = !keep[u] ? -INFINITY : a.bias != nullptr ? __fadd_rn(x, add[u]) : x;
                    }
                }
            }
            __syncthreads();
            // ... then the softmax of each row, a warp a row
            for (int r = warp; r < nrows; r += WARPS) {
                float* lr = lg + (size_t)r * ld;
                float m = -INFINITY;
                for (int e = lane; e < width; e += 32) m = fmaxf(m, lr[e]);
                m = warp_max(m);
                float sum = 0.f;
                if (m != -INFINITY)
                    for (int e = lane; e < width; e += 32) sum += expf(lr[e] - m);
                sum = warp_sum(sum);
                for (int e = lane; e < width; e += 32)
                    lr[e] = sum > 0.f ? __bfloat162float(__float2bfloat16_rn(__fdiv_rn(expf(lr[e] - m), sum))) : 0.f;
                if (lane == 0) {
                    row_m[r] = m;
                    row_l[r] = sum;
                }
            }
            __syncthreads();
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // sum the key ranges' partial outputs
    for (int e = tid; e < nrows * D; e += THREADS) {
        const int r = e / D, d = e % D, rr = r0 + r;
        float o = 0.f;
#pragma unroll
        for (int p = 0; p < G::KP; ++p) o += acc[(p * nr + r) * D + d];
        const size_t row = ((size_t)b * a.Tq + rr % a.Tq) * a.H + g * rep + rr / a.Tq;
        if (a.splits == 1) {
            a.out[row * D + d] = o;
        } else {
            const size_t prow = (size_t)split * a.B * a.Tq * a.H + row;
            a.part_o[prow * D + d] = o;
            if (d == 0) {
                a.part_ml[2 * prow] = row_m[r];
                a.part_ml[2 * prow + 1] = row_l[r];
            }
        }
    }
}

// one block a (b, t, h) row, one thread a column: the splits' outputs
// weighed by their sums at the row's max
template <int D>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml, float* __restrict__ out,
               int splits, int rows) {
    const int row = blockIdx.x, d = threadIdx.x;
    float m = -INFINITY;
    for (int s = 0; s < splits; ++s) {
        const size_t p = (size_t)s * rows + row;
        if (part_ml[2 * p + 1] > 0.f) m = fmaxf(m, part_ml[2 * p]);
    }
    float w = 0.f, o = 0.f;
    for (int s = 0; s < splits; ++s) {
        const size_t p = (size_t)s * rows + row;
        const float l = part_ml[2 * p + 1];
        if (l > 0.f) {
            const float ws = l * expf(part_ml[2 * p] - m);
            w += ws;
            o = fmaf(ws, part_o[p * D + d], o);
        }
    }
    out[(size_t)row * D + d] = w > 0.f ? __fdiv_rn(o, w) : 0.f;
}

template <int D>
size_t smem_bytes(int block_rows, int per) {
    return (size_t)STAGES * Geo<D>::STAGE + (size_t)block_rows * D * 4 + (size_t)block_rows * per * TILE * 4 +
           (size_t)Geo<D>::KP * block_rows * D * 4 + (size_t)per * 4 + 2 * block_rows * 4;
}

template <int D>
int launch(const Args& a, cudaStream_t st) {
    const size_t smem = smem_bytes<D>(a.block_rows, a.per);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    auto kern = decode_attn_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(a.splits, a.kvH * a.row_blocks, a.B), THREADS, smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.splits == 1) return (int)err;
    combine_kernel<D><<<a.B * a.Tq * a.H, D, 0, st>>>(a.part_o, a.part_ml, a.out, a.splits, a.B * a.Tq * a.H);
    return (int)cudaGetLastError();
}

// registers, dynamic shared memory, blocks per SM, local (spill) bytes
template <int D>
int info(int block_rows, int per, int* out) {
    const size_t smem = smem_bytes<D>(block_rows, per);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    auto kern = decode_attn_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, (const void*)kern);
    int blocks = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)smem;
    out[2] = blocks;
    out[3] = (int)attr.localSizeBytes;
    return 0;
}

bool rows_aligned(const void* p, long long s_b, long long s_l, long long s_h) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s_b % 8 == 0 && s_l % 8 == 0 && s_h % 8 == 0;
}

}  // namespace

extern "C" {

// q (B, Tq, H, hd) bf16 contiguous; k, v bf16 cache buffers (B, >= n_keys,
// kvH, hd) with the head dim contiguous and the other strides (k_s*, v_s*,
// elements) multiples of 8, 16-byte aligned; mask bool (B, Tq, n_keys) by
// its strides (0 on a broadcast axis; mrows 1 when it has one row);
// bias f32 (B, H, Tq, n_keys) by its strides, or null; out (B, Tq, H, hd)
// f32; part_o (splits, B, Tq, H, hd) and part_ml (splits, B, Tq, H, 2) f32
// scratch where splits > 1.  The plan (splits x per tiles of 64 keys cover
// n_keys, each split at least one tile; row_blocks x block_rows >= H / kvH
// x Tq, block_rows <= 16) is ops/decode_attention.py `plan`.
int vqa_decode_attn(const void* q, const void* k, const void* v, const void* mask, const void* bias, void* out,
                    void* part_o, void* part_ml, int B, int Tq, int H, int kvH, int hd, int n_keys, int mrows,
                    int splits, int per, int row_blocks, int block_rows, long long k_sb, long long k_sl,
                    long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long m_sb, long long m_st,
                    long long m_sj, long long b_sb, long long b_sh, long long b_st, long long b_sj, float scale,
                    void* stream) {
    if (B < 1 || Tq < 1 || kvH < 1 || H < kvH || H % kvH != 0 || n_keys < 1 || (mrows != 1 && mrows != Tq))
        return (int)cudaErrorInvalidValue;
    if (splits < 1 || per < 1 || (long long)splits * per * TILE < n_keys ||
        (long long)(splits - 1) * per * TILE >= n_keys)
        return (int)cudaErrorInvalidValue;
    if (block_rows < 1 || block_rows > MAX_ROWS || row_blocks < 1 || row_blocks * block_rows < H / kvH * Tq ||
        (row_blocks - 1) * block_rows >= H / kvH * Tq)
        return (int)cudaErrorInvalidValue;
    if (splits > 1 && (part_o == nullptr || part_ml == nullptr)) return (int)cudaErrorInvalidValue;
    Args a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.mask = static_cast<const uint8_t*>(mask);
    a.bias = static_cast<const float*>(bias);
    a.out = static_cast<float*>(out);
    a.part_o = static_cast<float*>(part_o);
    a.part_ml = static_cast<float*>(part_ml);
    a.B = B, a.Tq = Tq, a.H = H, a.kvH = kvH, a.n_keys = n_keys, a.mrows = mrows;
    a.splits = splits, a.per = per, a.row_blocks = row_blocks, a.block_rows = block_rows;
    a.ks[0] = k_sb, a.ks[1] = k_sl, a.ks[2] = k_sh;
    a.vs[0] = v_sb, a.vs[1] = v_sl, a.vs[2] = v_sh;
    a.ms[0] = m_sb, a.ms[1] = m_st, a.ms[2] = m_sj;
    a.bs[0] = b_sb, a.bs[1] = b_sh, a.bs[2] = b_st, a.bs[3] = b_sj;
    a.scale = scale;
    if (!rows_aligned(k, k_sb, k_sl, k_sh) || !rows_aligned(v, v_sb, v_sl, v_sh)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 64: return launch<64>(a, st);
        case 128: return launch<128>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// out[4] = registers a thread, dynamic shared memory, blocks per SM and
// local bytes a thread (spills) of the variant a call of (hd, block_rows,
// per) launches
int vqa_decode_attn_info(int hd, int block_rows, int per, int* out) {
    if (block_rows < 1 || block_rows > MAX_ROWS || per < 1) return (int)cudaErrorInvalidValue;
    switch (hd) {
        case 64: return info<64>(block_rows, per, out);
        case 128: return info<128>(block_rows, per, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
