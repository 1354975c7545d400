// Hopper (sm_90a) building blocks of the flash kernels (flash_fwd.cu,
// flash_bwd.cu), the bf16 and int8 top-k scans (topk.cu) and the w8 GEMM
// (w8_matmul.cu): mbarriers, TMA tensor maps and loads (multicast across a
// thread-block cluster too), cluster ranks, barriers and remote mbarrier
// arrivals, wgmma shared-memory descriptors and the products themselves,
// and the register layout of a wgmma accumulator.
//
// Operand tiles live in shared memory as TMA writes them with a 128-byte
// (64-byte at head dim 32) swizzle: a (rows, HD) bf16 tile is HD / PW
// panels of PW = SWB / 2 columns, panel p at p * rows * SWB, row r of a
// panel at r * SWB, each panel 1024-byte aligned.  The same tile is read
// K-major (the contraction runs along its columns: Q, K in S = Q K^T) or
// MN-major (the contraction runs along its rows: V in P V, K in dS K).
//
// Accumulator layout of wgmma.m64nNk16 (f32): thread t of the warpgroup
// (warp w = t / 32, lane l) holds rows w * 16 + l / 4 and that + 8, and in
// each 8-column chunk j the columns 8 j + 2 (l % 4) and + 1: element
// d[4 j + 2 i + c] is (row w * 16 + l / 4 + 8 i, column 8 j + 2 (l % 4) + c).
// The A fragment of a register-sourced product (k16) has the same
// row/column map, so a row of probabilities moves from an accumulator to
// an A operand without leaving the thread (see pack_a).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr float NEG_INF = -1e30f;  // the finite mask value of the reference

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// the row pitch, in floats, of an f32 operand that TMA reads (the bias,
// lse and dd rows): a multiple of 4 floats, since TMA's strides and the
// starts of its 1-D boxes are 16-byte multiples (ops/attention.py
// _f32_rows pads them so)
__host__ __device__ constexpr int f32_pitch(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, which the layouts need 1024-byte aligned (the
// 128-byte swizzle repeats every 1024 bytes).  It starts the block's
// shared window, so it is; a launch that found it otherwise traps rather
// than read misplaced tiles (a 1 KB pad would cost the encoder form its
// second block an SM).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
    if (smem_u32(raw) & 1023u) __trap();
    return raw;
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// wait until the phase of parity `parity` has completed; a wait that lasts
// seconds (a lost transaction: a fault, never a slow load) traps, so the
// launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint64_t start = 0;
    for (uint32_t n = 1;; ++n) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (done) return;
        if ((n & 1023) == 0) {
            const uint64_t now = global_ns();
            if (start == 0) start = now;
            else if (now - start > 4000000000ull) __trap();
        }
    }
}

// ---- TMA -----------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
    asm volatile(
        "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
        : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}
// one load written to the same shared offset of every CTA of the cluster in
// `mask`, each completing `bytes` on its own mbarrier at `bar`'s offset
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                                      int c2, uint16_t mask) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
        "h"(mask)
        : "memory");
}

// ---- clusters --------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
__device__ __forceinline__ uint32_t cluster_ctas() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
    return r;
}
// every thread of every CTA of the cluster: barrier inits before it are seen
// by the peers, and no CTA leaves while a peer may still write its shared
// memory or arrive on its barriers
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// arrive once on the mbarrier at `bar`'s offset in CTA `rank` of the
// cluster (default .release.cta semantics, as CUTLASS's ClusterBarrier: a
// .release.cluster arrival costs a cluster-wide fence, and a ring stage's
// release pays it on the critical path)
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// load a (rows, HD) bf16 tile, rows r0.. of slab c2, as HD / PW swizzled panels
template <int HD, int SWB>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar, int rows, int r0, int c2) {
    constexpr int PW = SWB / 2;
#pragma unroll
    for (int p = 0; p < HD / PW; ++p)
        tma_load_3d(static_cast<unsigned char*>(dst) + p * rows * SWB, map, bar, p * PW, r0, c2);
}

// Host side: cuTensorMapEncodeTiled reached through the runtime, so the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A tensor map over a contiguous tensor of dims n[0] (innermost) .. n[rank
// - 1] with elements of `elem` bytes, read in boxes `box`; elements past an
// edge read as zeros.  Returns false if the driver refuses it.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int rank,
                       const uint64_t* n, const uint32_t* box, CUtensorMapSwizzle swizzle) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr || base == nullptr) return false;
    cuuint64_t dims[3], strides[2];
    cuuint32_t boxes[3], ones[3] = {1, 1, 1};
    uint64_t stride = (uint64_t)elem;
    for (int i = 0; i < rank; ++i) {
        dims[i] = n[i];
        boxes[i] = box[i];
        stride *= n[i];
        if (i + 1 < rank) strides[i] = stride;
    }
    return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, boxes, ones,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (slabs, rows, HD) bf16, boxes of PW columns x box_rows rows, swizzled
inline bool map_bf16_tiles(CUtensorMap* map, const void* base, int slabs, int rows, int hd, int box_rows) {
    const int swb = hd >= 64 ? 128 : 64;
    const uint64_t n[3] = {(uint64_t)hd, (uint64_t)rows, (uint64_t)slabs};
    const uint32_t box[3] = {(uint32_t)(swb / 2), (uint32_t)box_rows, 1u};
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, 3, n, box,
                      swb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// (rows, cols) int8, boxes of 128 columns x box_rows rows, 128-byte
// swizzle: the byte layout of map_bf16_tiles's 64-column panels
inline bool map_s8_tiles(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
    const uint64_t n[3] = {(uint64_t)cols, (uint64_t)rows, 1u};
    const uint32_t box[3] = {128u, (uint32_t)box_rows, 1u};
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, 3, n, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// a (rows, cols) row-major matrix of `elem`-byte elements, boxes of
// box_cols x box_rows with a 128-byte swizzle (box_cols * elem = 128)
inline bool map_2d_swizzled(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int rows, int cols,
                            int box_rows, int box_cols) {
    const uint64_t n[2] = {(uint64_t)cols, (uint64_t)rows};
    const uint32_t box[2] = {(uint32_t)box_cols, (uint32_t)box_rows};
    return encode_map(map, type, elem, base, 2, n, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// (heads, rows, cols) f32 bias, boxes of 32 columns x box_rows rows, 128-byte swizzle
inline bool map_f32_tiles(CUtensorMap* map, const void* base, int heads, int rows, int cols, int box_rows) {
    const uint64_t n[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)heads};
    const uint32_t box[3] = {32u, (uint32_t)box_rows, 1u};
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, 3, n, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// n f32 values read as one vector of `box` values
inline bool map_f32_vector(CUtensorMap* map, const void* base, uint64_t n, int box) {
    const uint32_t b[1] = {(uint32_t)box};
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, 1, &n, b, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// element (r, c) of a (rows, cols) f32 tile loaded by map_f32_tiles:
// panels of 32 columns, the 16-byte chunk index XORed with r % 8
__device__ __forceinline__ float f32_tile_at(const float* tile, int rows, int r, int c) {
    const int p = c >> 5, cc = c & 31;
    const int chunk = (cc >> 2) ^ (r & 7);
    return tile[p * rows * 32 + r * 32 + chunk * 4 + (cc & 3)];
}

// ---- wgmma ---------------------------------------------------------------

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle mode (1: 128 B, 2: 64 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int swb) {
    const uint64_t layout = swb == 128 ? 1 : 2;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows row0.. (a multiple of 8) of a (rows, HD) tile, the
// 16 columns of k-step kk
template <int HD, int SWB>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int rows, int row0, int kk) {
    constexpr int PW = SWB / 2;
    const uint32_t a = smem_u32(tile) + (kk * 16 / PW) * rows * SWB + row0 * SWB + (kk * 16 % PW) * 2;
    return make_desc(a, 16, 8 * SWB, SWB);
}

// MN-major operand: rows 16 kk .. 16 kk + 15 of a (rows, HD) tile as the
// contraction, all HD columns as N
template <int HD, int SWB>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int rows, int kk) {
    const uint32_t a = smem_u32(tile) + kk * 16 * SWB;
    return make_desc(a, rows * SWB, 8 * SWB, SWB);
}

// a barrier of the 128 threads of one warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// The ring's release: warpgroup `wg` is done with the stage whose counter
// is `cnt`; the second of the two consumer warpgroups to get there refills
// the stage at once (refill() issues the next tile's loads), so the loads
// run a stage ahead and neither warpgroup waits for the other.
template <typename Refill>
__device__ __forceinline__ void release_stage(uint32_t* cnt, int wg, Refill refill) {
    wg_barrier(1 + wg);
    if ((threadIdx.x & 127) == 0 && (atomicAdd(cnt, 1u) & 1u)) refill();
    __syncwarp();
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma registers across the
// asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) asm volatile("" : "+r"(r[i][u])::"memory");
}


// d (64 x 64 f32) {+}= A (64 x 16, smem desc) * B (16 x 64, K-major smem desc)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) {+}= A (64 x 16, smem desc) * B (16 x 128, K-major smem desc)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 s32) {+}= A (64 x 32 s8, smem desc) * B (32 x 128 s8, K-major smem
// desc): 8-bit products take K-major operands only; the accumulator layout
// is the f32 one above
__device__ __forceinline__ void wgmma_ss_s8_n128(uint32_t (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32 f32) += A (64 x 16 bf16, registers) * B (16 x 32, MN-major smem desc)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major smem desc)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) * B (16 x 128, MN-major smem desc)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
    static_assert(N == 64 || N == 128, "S products are 64 or 128 wide");
    if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
    else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
    static_assert(N == 32 || N == 64 || N == 128, "head dims 32, 64, 128");
    if constexpr (N == 32) wgmma_rs_n32(d, a, db);
    else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
    else wgmma_rs_n128(d, a, db);
}

// two f32 -> packed bf16x2 (the lower column in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator (64 x N) -> A fragments of N / 16 k-steps, rounded to bf16
template <int N>
__device__ __forceinline__ void pack_a(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) a[kk][u] = pack_bf16(d[8 * kk + 2 * u], d[8 * kk + 2 * u + 1]);
}

// a thread's rows of a warpgroup's 64 x N accumulator written as bf16 rows
// row0 + (its rows) of a (*, HD) tensor, rows at or past `limit` skipped
template <int N>
__device__ __forceinline__ void store_rows(const float (&d)[N / 2], __nv_bfloat16* __restrict__ dst, int row0,
                                           int limit, float scale_a, float scale_b) {
    const int t = threadIdx.x & 127, r = row0 + (t >> 5) * 16 + ((t & 31) >> 2), c = 2 * (t & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = r + 8 * i;
        if (row >= limit) continue;
        const float s = i ? scale_b : scale_a;
        __nv_bfloat16* out = dst + (size_t)row * N + c;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
            *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(d[4 * j + 2 * i] * s, d[4 * j + 2 * i + 1] * s);
    }
}

// ---- tile ranges -----------------------------------------------------------

// The key tiles [lo, hi] that rows [r0, r0 + rows) (those below tq) must
// visit: none wholly past kv_len, above the causal diagonal or below the
// window band -- such tiles hold no kept key of these rows.  A row that
// keeps no key at all (kv_len 0, or a windowed row past kv_len + window - 1)
// averages V over every key in the forward; with `all_if_empty` such rows
// make the range every tile.  lo > hi: nothing to visit.  The rule is
// ops/attention.py:key_tile_range, which the CPU tests hold against the
// plain mask.
__host__ __device__ inline void key_tile_range(int r0, int rows, int bk, int tq, int tk, int len, bool causal,
                                               int window, bool all_if_empty, int& lo, int& hi) {
    const int r1 = (r0 + rows < tq ? r0 + rows : tq) - 1;
    lo = 0;
    hi = -1;
    if (r1 < r0) return;
    const bool empty_row = len <= 0 || (causal && window > 0 && r1 >= len + window - 1);
    if (empty_row && all_if_empty) {
        hi = cdiv(tk, bk) - 1;
        return;
    }
    int last = (len < tk ? len : tk) - 1;
    if (causal && r1 < last) last = r1;
    if (last < 0) return;
    if (causal && window > 0 && r0 - window + 1 > 0) lo = (r0 - window + 1) / bk;
    hi = last / bk;
}

// The query tiles [lo, hi] that keys [k0, k0 + keys) (those below kv_len and
// tk) meet in a kept pair; lo > hi: none.  ops/attention.py:query_tile_range.
__host__ __device__ inline void query_tile_range(int k0, int keys, int bq, int tq, int tk, int len, bool causal,
                                                 int window, int& lo, int& hi) {
    int k1 = k0 + keys;
    if (len < k1) k1 = len;
    if (tk < k1) k1 = tk;
    k1 -= 1;  // the last key of the range that any row keeps
    lo = 0;
    hi = -1;
    if (k1 < k0) return;
    int first = causal ? k0 : 0, last = tq - 1;
    if (causal && window > 0 && k1 + window - 1 < last) last = k1 + window - 1;
    if (first > last) return;
    lo = first / bq;
    hi = last / bq;
}

}  // namespace hopper
