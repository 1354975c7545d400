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
// (3072 x 12288 = 37.7 MB -> ~11 us at 3.35 TB/s; 3072 x 3072 = 9.4 MB ->
// 2.8 us, where a launch, the first bytes' latency and the tail of a
// partial wave cost as much as the stream).  The design streams every
// weight byte once with many bytes in flight on every SM, in one launch
// whose blocks all start in the first wave:
//
// - Work units are (16 rows of x, 128 output columns, 64 rows of K): 8 KB
//   of weights.  The grid is the resident slots (SMs x blocks an SM, from
//   the occupancy of this kernel), and block b takes units [b U / G,
//   (b + 1) U / G) of the U units in (output tile, K chunk) order, so the
//   shares differ by at most one unit and no partial wave is left
//   (ops/w8_matmul.py `partition` is the same rule, tested on the CPU).
// - Each unit's weight tile (64 x 128 int8) and x tile (16 x 64 bf16)
//   arrive by TMA with the 128-byte swizzle through an 8-stage ring
//   completed on mbarriers (80 KB in flight a block, two blocks an SM);
//   the warp that frees a stage last refills it.  The swizzle makes the
//   fragment reads below conflict-free.
// - 8 warps: four column groups of 32 columns x two K lanes (alternate
//   k16 steps).  A thread's B fragments for its four n8 tiles come from
//   four 32-bit shared loads (rows 2t, 2t+1, 2t+8, 2t+9 of the step, 4
//   adjacent columns: tile i's column g is physical column 4g + i), an
//   int8 code becomes bf16 by a byte permute, two logic ops and one bf16
//   subtraction a pair (bf16_pair), and the products run on the tensor
//   cores (mma.sync m16n8k16, bf16 in, f32 accumulate; M is padded to 16
//   rows by TMA's zero fill, whose cost is nil next to the weight stream).
// - A block accumulates consecutive units of one output tile in registers
//   (a segment); the K lanes are added in a fixed order.  A segment that
//   covers the whole K scales and writes y.  Only a share's first and last
//   segments can be partial, and both wait for the share's end (the first
//   held in registers), so no ticket stalls the stream: each writes its
//   unscaled partial to workspace slot b + o (unique: along the walk both
//   b and the tile o only grow), fences, and takes an integer ticket of
//   its tile; the block that arrives last adds the tile's partials in
//   split (K) order, scales once, writes y and sets the ticket back to 0,
//   so the next call (or a CUDA graph replay) needs no memset.  No float atomics: a result repeats bit for
//   bit on the same card.  The tickets are one buffer per device: calls
//   on one stream run one after another (the serving path uses one
//   stream); two calls in flight on different streams would share them.

#include <string.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NT = 128;                       // output columns of a unit: one 128-byte weight row
constexpr int GROUP = 32;                     // columns of a warp (four n8 mma tiles)
constexpr int NGROUPS = NT / GROUP;
constexpr int KLANES = WARPS / NGROUPS;       // warps splitting a unit's k16 steps
constexpr int KU = 64;                        // K rows of a unit
constexpr int MT = 16;                        // rows of x of a unit (the mma's M)
constexpr int STAGES = 8;
constexpr int BATCH = 12;                     // partials loaded at once by a tile's last block
constexpr uint32_t W_BYTES = KU * NT;         // int8 weight tile
constexpr uint32_t X_BYTES = MT * KU * 2;     // bf16 x tile
constexpr uint32_t STAGE_BYTES = W_BYTES + X_BYTES;
constexpr uint32_t RED_OFF = STAGES * STAGE_BYTES;
constexpr uint32_t RED_BYTES = 2 * MT * NT * 4;  // two segments' f32 sums
constexpr uint32_t BAR_OFF = RED_OFF + RED_BYTES;
constexpr uint32_t SMEM = BAR_OFF + 8 * STAGES + 4 * STAGES + 8;
static_assert(STAGE_BYTES % 1024 == 0, "every stage starts a 128-byte swizzle atom");

// byte i of `lo` and of `hi` (int8 codes) -> one register of two bf16, lo
// in the low half, exactly: a code c is (128 + (c & 127)) - (128 + (c &
// 128)), both terms bf16 (0x4300 | bits: 128 + bits) and their difference
// an integer of at most 8 bits -- a byte permute, two logic ops and one
// bf16x2 subtraction per two codes
// (c43 holds 0x43004300 in a register: lop3 takes one immediate, so each
// (p & mask) | 0x43004300 is then one instruction)
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi, int i, uint32_t c43) {
    const uint32_t p = __byte_perm(lo, hi, (uint32_t)(i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12)));
    uint32_t a, b;
    asm("lop3.b32 %0, %1, 0x007F007F, %2, 0xEA;\n" : "=r"(a) : "r"(p), "r"(c43));  // (p & 0x7F007F) | c43
    asm("lop3.b32 %0, %1, 0x00800080, %2, 0xEA;\n" : "=r"(b) : "r"(p), "r"(c43));
    const __nv_bfloat162 d =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a), *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the offset of byte c of row r of a tile of 128-byte rows that TMA wrote
// with the 128-byte swizzle (16-byte chunk index XOR r % 8)
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
    return (uint32_t)(r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15));
}
__device__ __forceinline__ uint32_t word(const unsigned char* base, uint32_t off) {
    return *reinterpret_cast<const uint32_t*>(base + off);
}

__device__ __forceinline__ void zero(float (&c)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}
__device__ __forceinline__ void copy(float (&d)[4][4], const float (&c)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = c[i][j];
}

__device__ __forceinline__ int ticket_add(int* ticket) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(ticket) : "memory");
    return old;
}

// the block whose share holds unit u (ops/w8_matmul.py Partition.block_of)
__device__ __forceinline__ int block_of(int u, int units, int grid) {
    return (int)(((long long)(u + 1) * grid - 1) / units);
}

// grid = the resident slots (at most the units); part holds grid + tiles - 1
// slots of MT x NT f32; tickets one int per output tile, zero between calls.
__global__ void __launch_bounds__(THREADS, 2)
w8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ ws, int M, int K, int N, float* __restrict__ part,
               int* __restrict__ tickets, float* __restrict__ y) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
    uint32_t* released = reinterpret_cast<uint32_t*>(full + STAGES);
    int* last = reinterpret_cast<int*>(released + STAGES);
    float* red = reinterpret_cast<float*>(smem + RED_OFF);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;         // mma fragment coordinates
    const int grp = warp % NGROUPS, kl = warp / NGROUPS;
    const int chunks = K / KU, col_tiles = N / NT;
    const int units = cdiv(M, MT) * col_tiles * chunks;  // < 2^31 (the host checks)
    const int grid = gridDim.x, b = blockIdx.x;
    const int u0 = (int)((long long)b * units / grid);
    const int n_units = (int)((long long)(b + 1) * units / grid) - u0;

    // the loads of the block's i-th unit into its stage
    auto issue = [&](int i) {
        const int u = u0 + i, o = u / chunks, ch = u - o * chunks;
        unsigned char* st = smem + (i % STAGES) * STAGE_BYTES;
        mbar_expect_tx(&full[i % STAGES], STAGE_BYTES);
        tma_load_2d(st, &tm_w, &full[i % STAGES], (o % col_tiles) * NT, ch * KU);
        tma_load_2d(st + W_BYTES, &tm_x, &full[i % STAGES], ch * KU, (o / col_tiles) * MT);
    };
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            released[s] = 0;
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0)
        for (int i = 0; i < STAGES && i < n_units; ++i) issue(i);

    float c[4][4], cf[4][4];  // this segment's sums; the block's first segment, held to the end
    zero(c);
    zero(cf);
    int o_first = -1, o_last = -1;  // the output tiles of the block's partial segments

    // the K lanes of a segment's sums into dst (MT x NT f32): lane 0 + lane 1
    auto lanes_to = [&](const float (&cc)[4][4], float* dst) {
        if (kl == 1) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int col = grp * GROUP + 8 * t + q;  // logical columns 2t, 2t+1 of tile q: physical 8t+q, 8t+4+q
                dst[g * NT + col] = cc[q][0];
                dst[g * NT + col + 4] = cc[q][1];
                dst[(g + 8) * NT + col] = cc[q][2];
                dst[(g + 8) * NT + col + 4] = cc[q][3];
            }
        }
        __syncthreads();
        if (kl == 0) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int col = grp * GROUP + 8 * t + q;
                dst[g * NT + col] = cc[q][0] + dst[g * NT + col];
                dst[g * NT + col + 4] = cc[q][1] + dst[g * NT + col + 4];
                dst[(g + 8) * NT + col] = cc[q][2] + dst[(g + 8) * NT + col];
                dst[(g + 8) * NT + col + 4] = cc[q][3] + dst[(g + 8) * NT + col + 4];
            }
        }
        __syncthreads();
    };
    // y rows of output tile o = sums * w_s, from 4 floats at a time
    auto store_y = [&](int o, int e, float4 v) {
        const int col = (o % col_tiles) * NT + 4 * (e % (NT / 4));
        const float4 sc = *reinterpret_cast<const float4*>(ws + col);
        *reinterpret_cast<float4*>(y + (size_t)((o / col_tiles) * MT + e / (NT / 4)) * N + col) =
            make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
    };
    // float4s of output tile o's rows below M
    auto vecs_of = [&](int o) { return min(MT, M - (o / col_tiles) * MT) * (NT / 4); };

    // This thread's fragment words, as byte offsets from a stage (the same in
    // every stage: stages start swizzle atoms): the weight rows 2t, 2t+1,
    // 2t+8, 2t+9 of its k16 steps kl + 2h (h adds 32 rows) at its 4 columns,
    // and the x words of its rows g (g + 8 adds 8 rows) at columns 2t and
    // 2t + 8 of k16 step kl + 2h.
    uint32_t w_off[4], x_off[KU / 16 / KLANES][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = kl * 16 + 2 * t + (e & 1) + 8 * (e >> 1);
        w_off[e] = swizzled(r, grp * GROUP + 4 * g);
    }
#pragma unroll
    for (int h = 0; h < KU / 16 / KLANES; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) x_off[h][j] = W_BYTES + swizzled(g, (h * KLANES + kl) * 32 + 16 * j + 4 * t);
    uint32_t c43;
    asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(c43));

    // the unit's output tile and K chunk, and the chunk where this segment began
    int o = u0 / chunks, ch = u0 - o * chunks, seg_lo = ch;
    for (int i = 0; i < n_units; ++i, ++ch) {
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        const unsigned char* st = smem + s * STAGE_BYTES;
#pragma unroll
        for (int h = 0; h < KU / 16 / KLANES; ++h) {
            const uint32_t a0 = word(st, x_off[h][0]), a1 = word(st, x_off[h][0] + 1024);
            const uint32_t a2 = word(st, x_off[h][1]), a3 = word(st, x_off[h][1] + 1024);
            const uint32_t r0 = word(st, w_off[0] + h * 4096), r1 = word(st, w_off[1] + h * 4096);
            const uint32_t r8 = word(st, w_off[2] + h * 4096), r9 = word(st, w_off[3] + h * 4096);
#pragma unroll
            for (int q = 0; q < 4; ++q)
                mma_bf16(c[q], a0, a1, a2, a3, bf16_pair(r0, r1, q, c43), bf16_pair(r8, r9, q, c43));
        }
        __syncwarp();
        if (lane == 0 && atomicAdd(&released[s], 1u) % WARPS == WARPS - 1 && i + STAGES < n_units) issue(i + STAGES);
        if (i + 1 < n_units && ch + 1 < chunks) continue;  // the segment goes on

        // the segment of tile o ends
        if (seg_lo == 0 && ch + 1 == chunks) {  // the whole K of tile o in this block: scale and write y
            lanes_to(c, red);
            for (int e = tid; e < vecs_of(o); e += THREADS) store_y(o, e, reinterpret_cast<const float4*>(red)[e]);
            __syncthreads();  // red is free again
        } else if (i + 1 < n_units) {  // the block's first segment: a tile's tail
            o_first = o;
            copy(cf, c);
        } else {
            o_last = o;
        }
        if (i + 1 < n_units) {  // the next segment begins a tile
            zero(c);
            ++o;
            ch = -1;
            seg_lo = 0;
        }
    }

    // The partial segments, at the end so that no ticket stalls the stream:
    // each writes its unscaled sums to slot b + o and takes a ticket of o;
    // the tile's last arriver adds its slots in split order and writes y.
    if (o_first < 0 && o_last < 0) return;
    const int pend[2] = {o_first, o_last};
    if (o_first >= 0) lanes_to(cf, red);
    if (o_last >= 0) lanes_to(c, red + MT * NT);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        if (pend[j] < 0) continue;
        float4* slot = reinterpret_cast<float4*>(part + (size_t)(b + pend[j]) * MT * NT);
        for (int e = tid; e < vecs_of(pend[j]); e += THREADS)
            slot[e] = reinterpret_cast<const float4*>(red + j * MT * NT)[e];
    }
    __syncthreads();
    if ((tid & 31) == 0 && tid < 64) {  // one thread a tile, both tickets at once
        const int j = tid >> 5, o = pend[j];
        last[j] = 0;
        if (o >= 0) {
            const int nseg = block_of((o + 1) * chunks - 1, units, grid) - block_of(o * chunks, units, grid) + 1;
            // acq_rel: the block's partials (ordered before it by the barrier)
            // reach the device first, and the last arriver's reads of the
            // others' come after it
            last[j] = ticket_add(&tickets[o]) == nseg - 1;
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        if (!last[j]) continue;  // every partial of tile pend[j] is written: add them in split order
        const int o = pend[j];
        const int first = block_of(o * chunks, units, grid);
        const int nseg = block_of((o + 1) * chunks - 1, units, grid) - first + 1;
        const float4* slots = reinterpret_cast<const float4*>(part + (size_t)(first + o) * MT * NT);
        for (int e = tid; e < vecs_of(o); e += THREADS) {
            float4 acc = __ldcg(slots + e);
            for (int j0 = 1; j0 < nseg; j0 += BATCH) {  // BATCH loads in flight, then the adds in order
                float4 v[BATCH];
#pragma unroll
                for (int q = 0; q < BATCH; ++q)
                    if (j0 + q < nseg) v[q] = __ldcg(slots + (size_t)(j0 + q) * (MT * NT / 4) + e);
#pragma unroll
                for (int q = 0; q < BATCH; ++q)
                    if (j0 + q < nseg) {
                        acc.x += v[q].x;
                        acc.y += v[q].y;
                        acc.z += v[q].z;
                        acc.w += v[q].w;
                    }
            }
            store_y(o, e, acc);
        }
        if (tid == 0) tickets[o] = 0;
    }
}

}  // namespace

extern "C" {

// x (M, K) bf16, w_q (K, N) int8 row-major, y (M, N) f32, each 16-byte
// aligned; w_s (N,) f32; K and N divisible by 128; grid in [1, units];
// part holds (grid + tiles - 1) * 16 * 128 f32 and tickets `tiles` zeroed
// ints, tiles = ceil(M / 16) * N / 128 (ops/w8_matmul.py partition).
int vqa_w8_matmul(const void* x, const void* wq, const void* ws, int M, int K, int N, int grid, void* part,
                  void* tickets, void* y, void* stream) {
    const long long units = (long long)cdiv(M, MT) * (N / NT) * (K / KU);
    if (units >= (1LL << 31) || M < 1 || K < 128 || N < 128 || K % 128 != 0 || N % 128 != 0 || grid < 1 || grid > units ||
        part == nullptr || tickets == nullptr || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(wq) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    CUtensorMap mx, mw;
    if (!map_2d_swizzled(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, MT, KU) ||
        !map_2d_swizzled(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, K, N, KU, NT))
        return (int)cudaErrorInvalidValue;
    // once a process (one device): the attribute call costs host time on every decode call
    static const cudaError_t attr =
        cudaFuncSetAttribute(w8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (attr != cudaSuccess) return (int)attr;
    const float* s = static_cast<const float*>(ws);
    float* pf = static_cast<float*>(part);
    int* tk = static_cast<int*>(tickets);
    float* yf = static_cast<float*>(y);
    void* args[] = {&mx, &mw, &s, &M, &K, &N, &pf, &tk, &yf};
    return (int)cudaLaunchKernel((const void*)w8_gemm_kernel, dim3(grid), dim3(THREADS), args, SMEM,
                                 static_cast<cudaStream_t>(stream));
}

// out[4] = blocks an SM, registers a thread, dynamic shared memory, local
// (spill) bytes a thread
int vqa_w8_info(int* out) {
    cudaError_t err = cudaFuncSetAttribute(w8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, (const void*)w8_gemm_kernel);
    int blocks = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, w8_gemm_kernel, THREADS, SMEM);
    if (err != cudaSuccess) return (int)err;
    out[0] = blocks;
    out[1] = attr.numRegs;
    out[2] = (int)SMEM;
    out[3] = (int)attr.localSizeBytes;
    return 0;
}

}  // extern "C"
