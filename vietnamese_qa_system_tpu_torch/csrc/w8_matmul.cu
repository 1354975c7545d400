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
// What bounds it on an H100: M is 1-256 (decode batches, the engine's
// 8 x 9-row speculative window, prefills), so the product does 2 M
// operations per int8 weight byte: below the ~295 bf16 operations a byte
// where the tensor cores become the limit up to M ~ 128, above it at M
// 256.  The weight bytes over HBM bandwidth bound the small M (3072 x
// 12288 = 37.7 MB -> ~11 us at 3.35 TB/s); the bf16 products bound M 256.
// So every weight byte crosses HBM once and is converted to bf16 once per
// call, whatever M is, and the products run on wgmma, the only route to
// the tensor cores' bf16 rate:
//
// - Swap AB: the kernel computes y^T = w_q^T x^T.  A work unit is all M
//   rows (padded to MP, a bucket of ops/w8_matmul.py `padded_rows`) x NT
//   output columns x 64 rows of K; a block has WGS warpgroups, each owning
//   64 of the unit's columns as the 64 rows of a wgmma's A, taken from
//   registers: the converted weights.  B is the x tile (MP rows x 64 K,
//   K-major as x is stored), and wgmma's n is MP (pieces of 256, 128 ... 8
//   columns where MP is no power of two).  NT is 256 (4 warpgroups) up to
//   MP 72 and 128 (2) above, where the sums of MP x 64 f32 a warpgroup
//   take most of a thread's registers.
// - A thread's A fragment of k16 step kk holds output rows g, g + 8 of its
//   warp's 16 at K rows 16 kk + 2t, 2t + 1 (+8): the kernel maps A row
//   16 w + g + 8 h to weight column 16 w + 2 g + h of its warpgroup's 64,
//   so one 16-bit shared load of a K row gives both of a thread's columns,
//   and an int8 code becomes bf16 by a byte permute, two logic ops and one
//   bf16 subtraction a pair (bf16_pair).  ops/w8_matmul.py
//   `fragment_columns` is the same map, checked on the CPU.
// - The grid is the resident slots (SMs x blocks an SM, from the occupancy
//   of the launched instance), and block b takes units [b U / G, (b + 1) U
//   / G) of the U units in (output tile, K chunk) order, so the shares
//   differ by at most one unit and no partial wave is left (ops/
//   w8_matmul.py `partition` is the same rule, tested on the CPU).
// - Each unit's weight tile (64 x NT int8, NT / 128 boxes) and x tile
//   arrive by TMA with the 128-byte swizzle through a ring of stages
//   completed on mbarriers (~200 KB in flight a block, one block an SM);
//   the warp that frees a stage last refills it.  The swizzle makes the
//   fragment loads conflict-free.
// - A block accumulates consecutive units of one output tile in registers
//   (a segment).  A segment that covers the whole K scales and writes y.
//   Only a share's first and last segments can be partial: each writes
//   its unscaled sums, row by row, to workspace slot b + o (unique: along
//   the walk both b and the tile o only grow), kept in L2 (the weight
//   stream is loaded evict-first), and at the share's end the block posts
//   an integer ticket for each (a post in mid-stream stalled the stream
//   behind its release).  The blocks whose shares end in the tile (all of
//   its blocks but perhaps the last, whose share starts there and runs on)
//   then wait for the tile's tickets and split its sum between them: each
//   adds a slice of the tile's rows over every slot in split (K) order,
//   scales once and writes y.  With few output tiles (12 at N 3072 and
//   256 columns) a tile's K is split over up to ~11 blocks, and one block
//   adding all of a 72-row tile's slots (~0.8 MB) took longer than the
//   stream: the slices spread that over the card.  A lone reducer (the
//   tile's first block) starts from its own sums and writes no slot.  All
//   blocks run at once (the grid is the resident slots) and a block posts
//   before it waits, so the waits end.  The last reducer past the wait
//   sets the tile's ticket and its count of reducers back to 0, so the
//   next call (or a CUDA graph replay) needs no memset.  No float atomics:
//   a result repeats bit for bit on the same card.  The tickets are one
//   buffer per device: calls on one stream run one after another (the
//   serving path uses one stream); two calls in flight on different
//   streams would share them.

#include <string.h>

#include <type_traits>

#include "hopper.cuh"

using namespace hopper;

// scripts/w8_ablations.py builds copies with one part taken out: 1 the
// weight stream alone (TMA loads, no conversion, products or epilogue),
// 2 no conversion (raw bytes into the products), 3 no products (the
// converted values folded by one logic op), 4 no split-K epilogue, 5 the
// split-K partials written and posted but never waited for nor added, 6 no
// wait for the tickets (the partials added as they are), 7 no partial
// written by a share's first segment (its ticket still posted)
#ifndef W8_ABLATION
#define W8_ABLATION 0
#endif

namespace {

constexpr int KU = 64;        // K rows of a unit
constexpr int BOX = 128;      // columns of a weight TMA box: one 128-byte swizzled row
constexpr int WG_COLS = 64;   // output columns of a warpgroup: the wgmma's M
constexpr int MAX_STAGES = 12;
constexpr uint32_t SMEM_BUDGET = 220 * 1024;

// warpgroups of a block at mp padded rows (ops/w8_matmul.py warpgroups):
// above 72 rows a warpgroup's 64 x mp f32 sums fill most of its registers
__host__ __device__ constexpr int warpgroups(int mp) { return mp <= 72 ? 4 : 2; }

// the compile-time plan of the instance for MP padded rows
template <int MP>
struct Plan {
    static_assert(MP % 8 == 0 && MP >= 8 && MP <= 256, "wgmma's n: a multiple of 8 up to 256");
    static constexpr int WGS = warpgroups(MP);
    static constexpr int THREADS = 128 * WGS;
    static constexpr int WARPS = THREADS / 32;
    static constexpr int NT = WG_COLS * WGS;  // output columns of a unit
    static constexpr int ACC = MP / 2;        // f32 sums a thread: 64 columns x MP rows a warpgroup
    static constexpr uint32_t W_BYTES = KU * NT;
    static constexpr uint32_t X_BYTES = MP * KU * 2;
    static constexpr uint32_t STAGE_BYTES = W_BYTES + X_BYTES;
    static constexpr int STAGES = SMEM_BUDGET / STAGE_BYTES < MAX_STAGES ? SMEM_BUDGET / STAGE_BYTES : MAX_STAGES;
    static constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
    static constexpr uint32_t SMEM = BAR_OFF + 8 * STAGES + 4 * STAGES;
    static_assert(STAGE_BYTES % 1024 == 0, "every stage starts a 128-byte swizzle atom");
    static_assert(STAGES >= 4, "a ring of at least 4 stages");
};

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

// d (64 x N f32) += A (64 x 16 bf16, registers) * B (16 x N, K-major smem
// desc): the swap-AB product, x's rows as wgmma's n
#define W8_F4(d, i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define W8_F8(d, i) W8_F4(d, i), W8_F4(d, (i) + 4)
#define W8_F16(d, i) W8_F8(d, i), W8_F8(d, (i) + 8)
#define W8_F32(d, i) W8_F16(d, i), W8_F16(d, (i) + 16)
#define W8_F64(d, i) W8_F32(d, i), W8_F32(d, (i) + 32)
#define W8_F128(d, i) W8_F64(d, i), W8_F64(d, (i) + 64)
template <int N>
__device__ __forceinline__ void wgmma_rs_k(float* d, const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_k<8>(float* d, const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : W8_F4(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_k<16>(float* d, const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : W8_F8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_k<32>(float* d, const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : W8_F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_k<64>(float* d, const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : W8_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_k<128>(float* d, const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : W8_F64(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_k<256>(float* d, const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : W8_F128(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the products of one k16 step over all MP rows: wgmma pieces of n = 256,
// 128, ... 8 columns of x's rows, each on its slice of the sums
template <int MP, int OFF = 0>
__device__ __forceinline__ void products(float (&acc)[MP / 2], const uint32_t (&a)[4], uint32_t x_addr) {
    constexpr int REST = MP - OFF;
    constexpr int P = REST >= 256 ? 256 : REST >= 128 ? 128 : REST >= 64 ? 64 : REST >= 32 ? 32 : REST >= 16 ? 16 : 8;
    wgmma_rs_k<P>(acc + OFF / 2, a, make_desc(x_addr + OFF * 128, 16, 1024, 128));
    if constexpr (OFF + P < MP) products<MP, OFF + P>(acc, a, x_addr);
}

// L2 policies: the weight stream is read once (evict first), so that it does
// not push the split-K partials, written and read back within the call,
// out to HBM (evict last)
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
    uint64_t p;
    if (keep) asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
    else asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
    return p;
}
__device__ __forceinline__ void tma_load_2d_hint(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                                 uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1, {%3, %4}], [%2], %5;\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(policy)
        : "memory");
}
__device__ __forceinline__ void store_kept2(float* p, float a, float b, uint64_t policy) {
    asm volatile("st.global.L2::cache_hint.v2.f32 [%0], {%1, %2}, %3;\n" ::"l"(p), "f"(a), "f"(b), "l"(policy)
                 : "memory");
}

// one more segment of a tile is in: release (cumulative), so the block's
// partials, ordered before it by the barrier, reach the device first
__device__ __forceinline__ void ticket_post(int* ticket) {
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(ticket) : "memory");
}
// until all n segments of the tile are in (acquire: the reads of their
// partials come after); a wait that lasts seconds (a fault: every block
// is resident, the grid being the resident slots) traps instead of
// hanging the card
__device__ __forceinline__ void ticket_wait(const int* ticket, int n) {
    uint64_t start = 0;
    for (uint32_t k = 1;; ++k) {
        int v;
        asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(ticket) : "memory");
        if (v >= n) return;
        if ((k & 255) == 0) {
            const uint64_t now = global_ns();
            if (start == 0) start = now;
            else if (now - start > 4000000000ull) __trap();
        }
    }
}

// the block whose share holds unit u (ops/w8_matmul.py Partition.block_of)
__device__ __forceinline__ int block_of(int u, int units, int grid) {
    return (int)(((long long)(u + 1) * grid - 1) / units);
}

// grid = the resident slots (at most the units); part holds grid + tiles - 1
// slots of MP x NT f32; tickets two ints per output tile (posted segments,
// finished reducers), zero between calls.
template <int MP>
__global__ void __launch_bounds__(Plan<MP>::THREADS, 1)
w8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ ws, int M, int K, int N, float* __restrict__ part,
               int* __restrict__ tickets, float* __restrict__ y) {
    using P = Plan<MP>;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
    uint32_t* released = reinterpret_cast<uint32_t*>(full + P::STAGES);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;  // wgmma fragment coordinates
    const int chunks = K / KU, tiles = cdiv(N, P::NT);
    const int units = tiles * chunks;  // < 2^31 (the host checks)
    const int grid = gridDim.x, b = blockIdx.x;
    const int u0 = (int)((long long)b * units / grid);
    const int n_units = (int)((long long)(b + 1) * units / grid) - u0;

    const uint64_t stream_policy = l2_policy(false), keep_policy = l2_policy(true);
    // the loads of the block's i-th unit into its stage (a box past N reads zeros)
    auto issue = [&](int i) {
        const int u = u0 + i, o = u / chunks, ch = u - o * chunks;
        unsigned char* st = smem + (i % P::STAGES) * P::STAGE_BYTES;
        uint64_t* bar = &full[i % P::STAGES];
        mbar_expect_tx(bar, P::STAGE_BYTES);
#pragma unroll
        for (int bx = 0; bx < P::NT / BOX; ++bx)
            tma_load_2d_hint(st + bx * KU * BOX, &tm_w, bar, o * P::NT + bx * BOX, ch * KU, stream_policy);
        tma_load_2d(st + P::W_BYTES, &tm_x, bar, ch * KU, 0);
    };
    if (tid == 0) {
        for (int s = 0; s < P::STAGES; ++s) {
            mbar_init(&full[s], 1);
            released[s] = 0;
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0)
        for (int i = 0; i < P::STAGES && i < n_units; ++i) issue(i);

    // This thread's weight columns 16 w + 2 g (+1) of its warpgroup's 64
    // (fragment_columns), as byte offsets in a stage of the K rows 2t and
    // 2t + 1 of a k16 step (the same in every stage: stages start swizzle
    // atoms; rows 16 kk + 8 and 9 add 1024 bytes, a k16 step 2048).
    const int col = wg * WG_COLS + 16 * w + 2 * g, cb = col % BOX;
    const uint32_t w_base = (uint32_t)((col / BOX) * KU * BOX + 2 * t * BOX + (cb & 15));
    const uint32_t w_off0 = w_base + ((((cb >> 4) ^ (2 * t)) & 7) << 4);
    const uint32_t w_off1 = w_base + BOX + ((((cb >> 4) ^ (2 * t + 1)) & 7) << 4);
    uint32_t c43;
    asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(c43));

    float acc[P::ACC];
#pragma unroll
    for (int r = 0; r < P::ACC; ++r) acc[r] = 0.f;

    // sums * w_s -> y rows below M of output tile o; a thread's register
    // 4 j + 2 h + e is (x row 8 j + 2 t + e, column col + h)
    auto store_y = [&](int o) {
        const int c = o * P::NT + col;
        if (c >= N) return;
        const float2 sc = *reinterpret_cast<const float2*>(ws + c);
#pragma unroll
        for (int j = 0; j < MP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int m = 8 * j + 2 * t + e;
                if (m < M)
                    *reinterpret_cast<float2*>(y + (size_t)m * N + c) =
                        make_float2(acc[4 * j + e] * sc.x, acc[4 * j + 2 + e] * sc.y);
            }
    };
    // The split of tile o: its first block, its segments (blocks), and its
    // reducers, the blocks whose shares end in it (all but perhaps the last,
    // whose share starts there and runs on; ops/w8_matmul.py
    // Partition.reducers).  A lone reducer is the tile's first block.
    struct Split {
        int first, nseg, reducers;
    };
    auto split_of = [&](int o) {
        Split sp;
        sp.first = block_of(o * chunks, units, grid);
        sp.nseg = block_of((o + 1) * chunks - 1, units, grid) - sp.first + 1;
        const int last_b = sp.first + sp.nseg - 1;
        sp.reducers = (long long)(last_b + 1) * units / grid <= (long long)(o + 1) * chunks ? sp.nseg : sp.nseg - 1;
        return sp;
    };
    const size_t slot_floats = (size_t)MP * P::NT;
    // a partial segment's sums to slot b + o as the tile's rows (row m,
    // unit column c at m * NT + c), rows below M, kept in L2
    auto write_partial = [&](int o) {
        float* slot = part + (size_t)(b + o) * slot_floats + col;
#pragma unroll
        for (int j = 0; j < MP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int m = 8 * j + 2 * t + e;
                if (m < M) store_kept2(slot + m * P::NT, acc[4 * j + e], acc[4 * j + 2 + e], keep_policy);
            }
    };
    // A reducer of tile o, once every segment's ticket is in: its slice of
    // the tile's rows (slice_of, in float4s), each summed over the slots in
    // split order and scaled once.  A lone reducer's own sums, in
    // registers, start the split order; it adds the others' slots to its
    // registers.  The last reducer past the wait sets the tile's two
    // counters back to 0.
    auto reduce = [&](int o) {
        const Split sp = split_of(o);
        const bool alone = sp.reducers == 1;
        if (tid == 0) {
            if (W8_ABLATION != 6) ticket_wait(&tickets[2 * o], alone ? sp.nseg - 1 : sp.nseg);
            if (atomicAdd(&tickets[2 * o + 1], 1) == sp.reducers - 1) {
                tickets[2 * o] = 0;  // every reducer has passed its wait
                tickets[2 * o + 1] = 0;
            }
        }
        __syncthreads();
        const float* slots = part + (size_t)(sp.first + o) * slot_floats;
        if (alone) {
            for (int s = 1; s < sp.nseg; ++s) {
                const float* src = slots + (size_t)s * slot_floats + col;
#pragma unroll
                for (int j = 0; j < MP / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int m = 8 * j + 2 * t + e;
                        if (m < M) {
                            const float2 v = __ldcg(reinterpret_cast<const float2*>(src + m * P::NT));
                            acc[4 * j + e] += v.x;
                            acc[4 * j + 2 + e] += v.y;
                        }
                    }
            }
            store_y(o);
            return;
        }
        // reducer k's float4s, U a thread at a time, the slots' loads SB at
        // a time in flight, then their adds in split order: U x SB loads in
        // flight, more float4s when there are few slots
        const int vecs = M * (P::NT / 4), k = b - sp.first;
        const int lo = (int)((long long)k * vecs / sp.reducers), hi = (int)((long long)(k + 1) * vecs / sp.reducers);
        const float4* slots4 = reinterpret_cast<const float4*>(slots);
        auto add_slice = [&](auto u_const, auto sb_const) {
            constexpr int U = decltype(u_const)::value, SB = decltype(sb_const)::value;
            for (int f0 = lo + tid; f0 < hi; f0 += U * P::THREADS) {
                float4 v[U];
                for (int s0 = 0; s0 < sp.nseg; s0 += SB) {
                    float4 w[SB][U];
#pragma unroll
                    for (int q = 0; q < SB; ++q)
#pragma unroll
                        for (int u = 0; u < U; ++u)
                            if (s0 + q < sp.nseg && f0 + u * P::THREADS < hi)
                                w[q][u] = __ldcg(slots4 + (size_t)(s0 + q) * (slot_floats / 4) + f0 + u * P::THREADS);
#pragma unroll
                    for (int q = 0; q < SB; ++q)
#pragma unroll
                        for (int u = 0; u < U; ++u)
                            if (s0 + q < sp.nseg && f0 + u * P::THREADS < hi) {
                                if (s0 + q == 0) {
                                    v[u] = w[q][u];
                                } else {
                                    v[u].x += w[q][u].x;
                                    v[u].y += w[q][u].y;
                                    v[u].z += w[q][u].z;
                                    v[u].w += w[q][u].w;
                                }
                            }
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int f = f0 + u * P::THREADS, m = f / (P::NT / 4);
                    const int c = o * P::NT + 4 * (f - m * (P::NT / 4));
                    if (f < hi && c < N) {
                        const float4 sc = *reinterpret_cast<const float4*>(ws + c);
                        *reinterpret_cast<float4*>(y + (size_t)m * N + c) =
                            make_float4(v[u].x * sc.x, v[u].y * sc.y, v[u].z * sc.z, v[u].w * sc.w);
                    }
                }
            }
        };
        if (sp.nseg <= 4) add_slice(std::integral_constant<int, 4>(), std::integral_constant<int, 4>());
        else add_slice(std::integral_constant<int, 2>(), std::integral_constant<int, 8>());
    };

    // this thread's weight fragments of k16 step kk of a unit, converted to
    // bf16 (A of the swap-AB product), from its stage
    auto convert = [&](const unsigned char* st, int kk, uint32_t (&a)[4]) {
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(st + w_off0 + kk * 2048);
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(st + w_off1 + kk * 2048);
        const uint32_t lo8 = *reinterpret_cast<const uint16_t*>(st + w_off0 + kk * 2048 + 1024);
        const uint32_t hi8 = *reinterpret_cast<const uint16_t*>(st + w_off1 + kk * 2048 + 1024);
        if (W8_ABLATION == 2) {
            a[0] = lo | (hi << 16);
            a[1] = hi | (lo << 16);
            a[2] = lo8 | (hi8 << 16);
            a[3] = hi8 | (lo8 << 16);
        } else {
            a[0] = bf16_pair(lo, hi, 0, c43);
            a[1] = bf16_pair(lo, hi, 1, c43);
            a[2] = bf16_pair(lo8, hi8, 0, c43);
            a[3] = bf16_pair(lo8, hi8, 1, c43);
        }
    };
    // the block is done with unit i's stage: the warp that frees it last refills it
    auto release = [&](int i) {
        __syncwarp();
        if (lane == 0 && atomicAdd(&released[i % P::STAGES], 1u) % P::WARPS == P::WARPS - 1 && i + P::STAGES < n_units)
            issue(i + P::STAGES);
    };

    // the unit's output tile and K chunk, and the chunk where this segment began
    int o = u0 / chunks, ch = u0 - o * chunks, seg_lo = ch;
    int o_first = -1, o_last = -1;  // the output tiles of the share's partial segments
    for (int i = 0; i < n_units; ++i, ++ch) {
        const int s = i % P::STAGES;
        mbar_wait(&full[s], (i / P::STAGES) & 1);
        const unsigned char* st = smem + s * P::STAGE_BYTES;
        if (W8_ABLATION != 1) {
            uint32_t a[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) convert(st, kk, a[kk]);
            if (W8_ABLATION == 3) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    acc[kk % P::ACC] = __uint_as_float(__float_as_uint(acc[kk % P::ACC]) ^ a[kk][0] ^ a[kk][1] ^
                                                       a[kk][2] ^ a[kk][3]);
            } else {
                const uint32_t x_addr = smem_u32(st + P::W_BYTES);
                fence_regs(acc);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) products<MP>(acc, a[kk], x_addr + kk * 32);
                wg_commit();
                wg_wait<0>();
                fence_regs(acc);
                fence_regs(a);
            }
        }
        release(i);
        if (i + 1 < n_units && ch + 1 < chunks) continue;  // the segment goes on

        // the segment of tile o ends
        if (W8_ABLATION == 1) {
        } else if (seg_lo == 0 && ch + 1 == chunks) {  // the whole K of tile o in this block: scale and write y
            store_y(o);
        } else if (i + 1 < n_units) {  // the share's first segment, the tail of tile o: its partial
            o_first = o;
            if (W8_ABLATION != 4 && W8_ABLATION != 7) write_partial(o);
        } else {  // the share's last segment, the head of tile o: its partial unless its block reduces alone
            o_last = o;
            if (W8_ABLATION != 4 && split_of(o).reducers > 1) write_partial(o);
        }
        if (i + 1 < n_units) {  // the next segment begins a tile
#pragma unroll
            for (int r = 0; r < P::ACC; ++r) acc[r] = 0.f;
            ++o;
            ch = -1;
            seg_lo = 0;
        }
    }

    // The tickets of the share's partial segments, posted at the share's
    // end (the tiles' reducers end their shares then too; a post mid-stream
    // stalled the stream behind its release), then the reduction of the
    // last segment's tile.
    if (W8_ABLATION == 4 || (o_first < 0 && o_last < 0)) return;
    __syncthreads();  // every thread's partial stores ordered before thread 0's release (cumulative)
    if (tid == 0) {
        if (o_first >= 0) ticket_post(&tickets[2 * o_first]);
        if (o_last >= 0 && split_of(o_last).reducers > 1) ticket_post(&tickets[2 * o_last]);
    }
    if (o_last >= 0 && W8_ABLATION != 5) reduce(o_last);
}

// the padded row counts the kernel is built for (ops/w8_matmul.py ROW_BUCKETS)
#define W8_BUCKETS(X) X(8) X(16) X(32) X(48) X(64) X(72) X(96) X(128) X(192) X(256)

template <int MP>
cudaError_t set_smem() {
    return cudaFuncSetAttribute(w8_gemm_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Plan<MP>::SMEM);
}

template <int MP>
int launch(const void* x, const void* wq, const float* ws, int M, int K, int N, int grid, float* part, int* tickets,
           float* y, cudaStream_t stream) {
    CUtensorMap mx, mw;
    if (!map_2d_swizzled(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, MP, KU) ||
        !map_2d_swizzled(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, K, N, KU, BOX))
        return (int)cudaErrorInvalidValue;
    // once a process (one device): the attribute call costs host time on every decode call
    static const cudaError_t attr = set_smem<MP>();
    if (attr != cudaSuccess) return (int)attr;
    void* args[] = {&mx, &mw, &ws, &M, &K, &N, &part, &tickets, &y};
    return (int)cudaLaunchKernel((const void*)w8_gemm_kernel<MP>, dim3(grid), dim3(Plan<MP>::THREADS), args,
                                 Plan<MP>::SMEM, stream);
}

template <int MP>
int info(int* out) {
    cudaError_t err = set_smem<MP>();
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, (const void*)w8_gemm_kernel<MP>);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, w8_gemm_kernel<MP>, Plan<MP>::THREADS,
                                                            Plan<MP>::SMEM);
    if (err != cudaSuccess) return (int)err;
    out[0] = blocks;
    out[1] = attr.numRegs;
    out[2] = (int)Plan<MP>::SMEM;
    out[3] = (int)attr.localSizeBytes;
    out[4] = Plan<MP>::THREADS;
    out[5] = Plan<MP>::NT;
    out[6] = Plan<MP>::STAGES;
    return 0;
}

}  // namespace

extern "C" {

// x (M, K) bf16, w_q (K, N) int8 row-major, y (M, N) f32, each 16-byte
// aligned; w_s (N,) f32; K and N divisible by 128; mp the bucket of M
// (ops/w8_matmul.py padded_rows); grid in [1, units]; part holds (grid +
// tiles - 1) * mp * NT f32 and tickets 2 * tiles zeroed ints, tiles =
// ceil(N / NT) (ops/w8_matmul.py partition).
int vqa_w8_matmul(const void* x, const void* wq, const void* ws, int M, int K, int N, int mp, int grid, void* part,
                  void* tickets, void* y, void* stream) {
    const long long units = (long long)cdiv(N, WG_COLS * warpgroups(mp)) * (K / KU);
    if (units >= (1LL << 31) || M < 1 || M > mp || K < 128 || N < 128 || K % 128 != 0 || N % 128 != 0 || grid < 1 ||
        grid > units || part == nullptr || tickets == nullptr || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(wq) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const float* s = static_cast<const float*>(ws);
    float* pf = static_cast<float*>(part);
    int* tk = static_cast<int*>(tickets);
    float* yf = static_cast<float*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mp) {
#define W8_CASE(B) \
    case B: return launch<B>(x, wq, s, M, K, N, grid, pf, tk, yf, st);
        W8_BUCKETS(W8_CASE)
#undef W8_CASE
        default: return (int)cudaErrorInvalidValue;
    }
}

// out[7] = blocks an SM, registers a thread, dynamic shared memory, local
// (spill) bytes a thread, threads a block, output columns a unit, ring
// stages of the instance for mp padded rows
int vqa_w8_info(int mp, int* out) {
    switch (mp) {
#define W8_CASE(B) \
    case B: return info<B>(out);
        W8_BUCKETS(W8_CASE)
#undef W8_CASE
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
