// Warp-specialised wgmma + TMA GEMM of the chain kernels K2 / K3 / K5
// (chain_grad.cu) and of K1 (fused_encoder.cu), hand-written for Hopper
// (sm_90a), with a stage's LayerNorm fused into its epilogue across a
// thread-block cluster.
//
//   C (M, N) = op(A) (M, K) @ op(B) (K, N), f32 accumulate; operands bf16
//   (wgmma main loop) or f32 (3xTF32 wgmma main loop, F32 = 1; see below)
//
// Three operand forms, each brought in by TMA as it is stored (bf16:
// wgmma's transpose bits; f32: the split pass below; no transposing copy
// in device memory):
//   FWD  z  = h W:     A = h (M, K) K-major; B = W stored (K, N), MN-major;
//   DH   dh = dz W^T:  A = dz (M, K) K-major; B = W stored (N, K), K-major;
//   DW   dW = h^T dz:  A = h stored (K, M), MN-major; B = dz stored (K, N),
//                      MN-major.  blockIdx.z takes the K-slice
//                      [z * ksplit, (z + 1) * ksplit) and writes its own
//                      partial product; the caller sums the slices in
//                      order (no float atomics anywhere).
// Three epilogues:
//   STORE   f32 C (+ bias), masked at the ragged M / N edges;
//   LN_FWD  the forward LayerNorm + ReLU of one stage: z = acc + b, its
//           mean, then its variance (two passes, eps 1e-6), each summed
//           over the cluster; h = relu(ln) in the operand type; and the
//           bf16 stash of z (K2 in bf16), the f32 z (K2's stash in f32,
//           K5's recompute) or neither (K5's forward);
//   LN_BWD  one stage's backward from dh = acc and the stage's z (bf16
//           stash, K3 in bf16; f32 z, K3 in f32 and K5): the statistics
//           rebuilt (two cluster sums); h rebuilt (K3); jnp.maximum's tie
//           rule (half the cotangent at ln == 0) and the LayerNorm
//           backward (a third cluster sum, of dxhat and dxhat * xhat); dz
//           in the operand type; and per-CTA column partials of d gamma,
//           d beta and d b;
//   POOL    the point encoder's projection (K1): f = acc + b, as STORE
//           adds it, then per column over the tile's rows the masked and
//           unmasked sums and maxima, the valid count and the kv window
//           masked max over p consecutive rows; optionally f itself.
// f32 z (forward) and f32 dh (backward) never reach device memory.
//
// Design: a 128 x 256 output tile per CTA and three warpgroups: two
// consumers (64 rows each, a 64 x 256 f32 accumulator in 128 registers a
// thread, setmaxnreg 232) and a producer (setmaxnreg 40) whose one thread
// keeps a ring of 4 shared-memory stages (128 x 64 of A, 64 x 256 of B)
// full by TMA, with 128-byte swizzle, guarded by full / empty mbarriers.
// TMA zero-fills boxes outside the tensor, so ragged M, N and K need no
// masking in the main loop.  A LayerNorm stage of width W <= 2048 runs as
// a cluster of ceil(W / 256) <= 8 CTAs along N (the portable limit); row
// partial sums go through distributed shared memory and every CTA adds
// the cluster's partials in rank order, so results repeat bit for bit.
// A wider stage does not use LN_FWD / LN_BWD: its product goes through
// STORE to device memory in f32 and layernorm_rows.cu's row kernels
// normalize it (forward) or take its LayerNorm backward.
// The LayerNorm epilogues put the accumulator into an f32 tile in the
// (then free) ring and work on it by rows, so they hold few registers
// beside it and store 16 contiguous bytes a lane.
//
// f32 operands (F32 = 1, the JAX kernels' compute_dtype=float32): wgmma
// takes f32 only as TF32 (10 mantissa bits), so each operand is split,
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a product is
// lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B) on the tensor cores (3xTF32,
// f32-accurate; lo(A) lo(B) ~ 2^-22 relative is dropped), in the same
// accumulator layout as bf16, so every epilogue runs unchanged.  TMA
// brings f32 stages 32 deep (128 x 32 + 32 x 256 floats: a bf16 stage's
// 48 KB) into a ring of 3.  TF32 wgmma reads B only from shared memory
// and only K-major, so for each half stage (16 k) the 256 consumer
// threads split B's rows into a K-major hi | lo tile (two of them, 32 KB
// each, after the ring), transposing an MN-major B on the way, while the
// tensor cores work on the other tile; A is split into registers
// (wgmma's register-A form, which has no majorness).  The tensor cores
// round each sum toward zero, so a STORE launch moves its accumulator
// into C every 2048 k (DW's K runs over the point rows).  The f32 stash
// needs no z tile: in f32 it is z = acc + b itself, written from the f32
// tile (LN_FWD), and read back from device memory (LN_BWD with ZF32), as
// K5's recomputed z is.
//
// POOL runs its row tiles per cloud (blockIdx.y = cloud * tiles + tile), so
// no tile holds rows of two clouds: TMA loads a whole 128-row box from the
// 2-D map of all rows and the epilogue drops the rows past the cloud's end.
// One thread takes one tile column and walks its rows in order (the f32
// tile in the freed ring, conflict-free), so every statistic is a fixed
// function of the inputs.  A kv window that lies in the tile is written
// whole; one that crosses a tile boundary (p not dividing 128) leaves a
// partial max in an edge slot of each tile it touches, for the caller to
// merge: slot 0 holds the window that began in an earlier tile, slot 1 the
// one that begins in this tile and ends in a later one.
//
// Everything here has internal linkage: each kernel library that includes
// the header gets its own copies of the launch flags and tensor-map cache.
//
// Tensor maps: cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no libcuda link), cached by address, shape,
// stride, box and element type.  TMA needs 16-byte row strides: the
// callers pad their buffers' rows to multiples of 8 elements.
//
// What bounds it: operations (a 128 x 256 x 64 bf16 step reads 48 KB for
// 2 M multiply-adds; an f32 step 48 KB for 1 M, each three TF32 ones at
// the dense TF32 rate: 494.7 / 3 TFLOP/s of f32 work).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace hgemm {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;
constexpr int BK_F32 = 32;                        // f32 depth of a stage
constexpr int STAGES = 4;
constexpr int STAGES_F32 = 3;                     // f32 ring stages
constexpr int KS = 16;                            // k of an f32 split tile
constexpr int FLUSH_STAGES = 64;                  // f32: 2048 k a sum
constexpr int CONSUMERS = 2;                      // warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;              // 16 KB
constexpr int B_BYTES = BK * BN * 2;              // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;  // 192 KB
// f32: 3 ring stages, then two split tiles of B (256 rows of KS hi and KS
// lo floats: 32 KB each).
constexpr int SPLIT_BYTES = BN * 2 * KS * 4;
constexpr int AREA_F32 = STAGES_F32 * STAGE_BYTES + 2 * SPLIT_BYTES;
constexpr int MAX_CLUSTER = 8;
constexpr int TILE_LD = BN + 8;                   // f32 epilogue tile rows
constexpr int ZT_LD = BN + 8;                     // bf16 z tile rows
constexpr int ZTILE = BM * TILE_LD * 4;           // z tile after the f32 one
constexpr int EPI_BYTES = ZTILE + BM * ZT_LD * 2;
constexpr int AREA_BF16 = RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES;
constexpr int AREA_BYTES = AREA_BF16 > AREA_F32 ? AREA_BF16 : AREA_F32;
constexpr int RED_FLOATS = 4 * BM;                // exchange slots
constexpr int SMEM_BYTES = 1024 + AREA_BYTES + RED_FLOATS * 4 +
                           2 * STAGES * 8;
static_assert(3 * 8 * BN * 4 <= ZTILE, "column partials");
static_assert(SMEM_BYTES <= 232448, "shared memory");
static_assert(BM * BK_F32 * 4 == A_BYTES && BK_F32 * BN * 4 == B_BYTES,
              "an f32 stage fills a bf16 stage's bytes");
static_assert(2 * KS == BK_F32 && 2 * KS * 4 == 128,
              "a split tile row is one 128-byte swizzle row");
static_assert((STAGES_F32 * STAGE_BYTES) % 1024 == 0, "split tile alignment");

enum { FWD = 0, DH = 1, DW = 2 };
enum { STORE = 0, LN_FWD = 1, LN_BWD = 2, POOL = 3 };

constexpr float NEG_SENTINEL = -1e30f;   // POOL's empty max

struct Params {
    CUtensorMap ta, tb;
    int M, N, K, ksplit;
    float* C;              // STORE
    int ldc;
    long long c_split;     // elements between K-slice partials
    const float* bias;     // STORE (FWD) and LN_FWD
    const float* gamma;
    const float* beta;
    void* H;               // LN_FWD: h; LN_BWD: rebuilt h (null: none);
    int ldh;               // bf16, or f32 with F32
    void* Z;               // LN_FWD: bf16 stash / f32 z / null out;
    int ldz, z_f32;        // LN_BWD: the bf16 stash or the f32 z in
    void* DZ;              // LN_BWD; bf16, or f32 with F32
    int lddz;
    float* part;           // LN_BWD: [row tile][3 N]
    // POOL: clouds of `rows` rows, `tiles` row tiles each.  C (ldc) takes
    // the features when not null.
    const uint8_t* valid;  // (M,) row validity
    float* pool;           // [cloud][tile][5][N]: masked sum, masked max,
                           // sum, max, valid count
    float* kv;             // [cloud][rows / kvp][N] (null: no kv pooling)
    float* edge;           // [cloud][tile][2][N] crossing windows' partials
    int rows, tiles, kvp;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The last barrier of a cluster epilogue: it only keeps every CTA alive
// until its peers have read its shared memory (values they have already
// used), so its arrive is relaxed and does not wait for the epilogue's
// global stores to drain, as a release would.
__device__ __forceinline__ void cluster_sync_last() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
                 "barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_ranks() {
    uint32_t n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
    return n;
}

// The float at shared address `local` in the CTA of cluster rank `rank`.
__device__ __forceinline__ float ld_cluster(uint32_t local, uint32_t rank) {
    uint32_t remote;
    float v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("ld.shared::cluster.f32 %0, [%1];"
                 : "=f"(v) : "r"(remote) : "memory");
    return v;
}

__device__ __forceinline__ void consumer_bar() {
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major: SBO = 1024
// (8 rows of 128 bytes), LBO unused.  MN-major: LBO = bytes between
// 64-element MN blocks, SBO = 1024 (8 K-rows of 128 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16) B (16 x 256), bf16; TA / TB: 1 for an
// MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, %131, %132;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ---------------------------------------------------------------------------
// Epilogue helpers.  The accumulator (m64nNk16, f32): thread t of a
// consumer warpgroup, warp w = t / 32, lane l, q = l % 4, holds rows
// r = 16 w + l / 4 and r + 8 of its 64, and for j < 32 the columns
// 8 j + 2 q and 8 j + 2 q + 1: acc[4 j + e] at (r, 8 j + 2 q + e),
// acc[4 j + 2 + e] at (r + 8, 8 j + 2 q + e).  The LayerNorm epilogues
// first put it into an f32 tile in the ring (free once the main loop is
// done) and then work by rows: warp v (0..7) of the two consumer
// warpgroups takes tile rows 16 v .. 16 v + 15, lane l the columns
// 8 l .. 8 l + 7.  That frees the accumulator's registers for the
// LayerNorm and makes every store 16 contiguous bytes a lane.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// A lane's 8 columns of a row: c0 + col(e) with c0 = n0 + 4 lane, i.e.
// 4 lane .. 4 lane + 3 and 128 + 4 lane .. 128 + 4 lane + 3 of the tile, so
// a quarter-warp's vector accesses cover 128 contiguous bytes (no bank
// conflicts) and a warp's stores 2 runs of contiguous bytes.
__device__ __forceinline__ constexpr int col(int e) {
    return e < 4 ? e : BN / 2 - 4 + e;
}

// v[e] = p[c0 + col(e)] where c0 + col(e) < n (0 elsewhere, and everywhere
// when !ok).  p + c0 is 16-byte aligned for f32, 8-byte for bf16.
__device__ __forceinline__ void load8(const float* p, int c0, int n, bool ok,
                                      float (&v)[8]) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
        const int c = c0 + g * (BN / 2);
        if (ok && c + 4 <= n) {
            const float4 a = *reinterpret_cast<const float4*>(p + c);
            v[4 * g] = a.x; v[4 * g + 1] = a.y;
            v[4 * g + 2] = a.z; v[4 * g + 3] = a.w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                v[4 * g + e] = ok && c + e < n ? p[c + e] : 0.0f;
        }
    }
}

__device__ __forceinline__ void load8(const bf16* p, int c0, int n, bool ok,
                                      float (&v)[8]) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
        const int c = c0 + g * (BN / 2);
        if (ok && c + 4 <= n) {
            const uint2 raw = *reinterpret_cast<const uint2*>(p + c);
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
            v[4 * g] = a.x; v[4 * g + 1] = a.y;
            v[4 * g + 2] = b.x; v[4 * g + 3] = b.y;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                v[4 * g + e] =
                    ok && c + e < n ? __bfloat162float(p[c + e]) : 0.0f;
        }
    }
}

// p[c0 + col(e)] = v[e] where c0 + col(e) < n.
__device__ __forceinline__ void store8(bf16* p, int c0, int n,
                                       const float (&v)[8]) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
        const int c = c0 + g * (BN / 2);
        if (c + 4 <= n) {
            uint2 raw;
            *reinterpret_cast<__nv_bfloat162*>(&raw.x) =
                __floats2bfloat162_rn(v[4 * g], v[4 * g + 1]);
            *reinterpret_cast<__nv_bfloat162*>(&raw.y) =
                __floats2bfloat162_rn(v[4 * g + 2], v[4 * g + 3]);
            *reinterpret_cast<uint2*>(p + c) = raw;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (c + e < n) p[c + e] = __float2bfloat16(v[4 * g + e]);
        }
    }
}

__device__ __forceinline__ void store8(float* p, int c0, int n,
                                       const float (&v)[8]) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
        const int c = c0 + g * (BN / 2);
        if (c + 4 <= n) {
            *reinterpret_cast<float4*>(p + c) = make_float4(
                v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (c + e < n) p[c + e] = v[4 * g + e];
        }
    }
}

__device__ __forceinline__ void store_f32x2(float* p, float a, float b,
                                            bool pair, bool aligned) {
    if (pair && aligned) {
        *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
        p[0] = a;
        if (pair) p[1] = b;
    }
}

// Cluster totals of NV per-row quantities.  On entry lane i < 16 of warp
// v holds in mine[k] this CTA's partial of quantity k for tile row
// 16 v + i; it publishes them in slot `red` ([NV][BM] floats of this
// CTA's shared memory) and, after the cluster barrier, adds every rank's
// partials in rank order, so all CTAs of the cluster get the same bits.
template <int NV>
__device__ __forceinline__ void cluster_rows(float (&mine)[NV], float* red,
                                             int v, int lane) {
    const int row = 16 * v + lane;
    if (lane < 16) {
#pragma unroll
        for (int k = 0; k < NV; ++k) red[k * BM + row] = mine[k];
    }
    cluster_sync();
    if (lane < 16) {
        const uint32_t base = smem_u32(red);
        const uint32_t ranks = cluster_ranks();
        float s[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k) s[k] = 0.0f;
        for (uint32_t rank = 0; rank < ranks; ++rank) {
#pragma unroll
            for (int k = 0; k < NV; ++k)
                s[k] += ld_cluster(base + 4 * (k * BM + row), rank);
        }
#pragma unroll
        for (int k = 0; k < NV; ++k) mine[k] = s[k];
    }
}

// 16 bytes from global to shared memory without registers; the bytes
// past `bytes` (0..16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ float bcast(float v, int lane) {
    return __shfl_sync(0xffffffffu, v, lane);
}

// ---------------------------------------------------------------------------
// The f32 main loop (F32 = 1): 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk `chunk` (0..7) of 128-byte row `row` in a
// tile written with the 128-byte swizzle (1024-byte aligned).
__device__ __forceinline__ int swz(int row, int chunk) {
    return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// x = hi + lo + O(2^-22 |x|): hi is x rounded to TF32 (10 mantissa bits,
// the bits the tensor core reads), lo the exact remainder x - hi rounded
// to TF32 in turn.
__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void fence_view_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d (64 x 256, f32) += A (64 x 8) B (8 x 256), TF32: A from registers in
// the m64k8 fragment layout (warp w of the warpgroup, lane l: rows
// 16 w + l / 4 and + 8, columns l % 4 and + 4, as a0 (r, c), a1 (r + 8, c),
// a2 (r, c + 4), a3 (r + 8, c + 4)); B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float (&d)[128],
                                                     const uint32_t* a,
                                                     uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %133, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, p, 1, 1;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One half of f32 ring stage s (KS = 16 of its 32 k, half h) made ready
// for the tensor cores:
//   - B: consumer thread t (0..255) splits tile row n = t, its 16 k, into
//     row n of the split tile `sp`: chunks 0-3 hold hi, chunks 4-7 lo
//     (128 bytes a row, 128-byte swizzle, K-major as TF32 wgmma reads B).
//     An MN-major stage (FWD's W, DW's dz: boxes of 32 n x 32 k) is
//     transposed on the way, a warp reading one 128-byte row of a box per
//     k (no bank conflicts);
//   - A: the thread's m64k8 fragments of its warpgroup's 64 rows, both
//     k8 steps, split into hi / lo registers; read from the K-major box
//     (128 m x 32 k) or, for DW, the MN-major boxes (32 m x 32 k).
// TMA zero-fills past the tensor, so ragged edges split to zeros.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void tf32x3_prep(const uint8_t* a, int h,
                                            uint8_t* sp, int r,
                                            uint32_t (&ah)[8],
                                            uint32_t (&al)[8]) {
    const uint8_t* b = a + A_BYTES;
    const int n = threadIdx.x;
    float x[KS];
    if (B_MN) {
#pragma unroll
        for (int i = 0; i < KS; ++i)
            x[i] = *reinterpret_cast<const float*>(
                b + (n >> 5) * 4096 + swz(KS * h + i, (n & 31) >> 2) +
                (n & 3) * 4);
    } else {
#pragma unroll
        for (int c = 0; c < KS / 4; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(
                b + swz(n, KS / 4 * h + c));
            x[4 * c] = v.x; x[4 * c + 1] = v.y;
            x[4 * c + 2] = v.z; x[4 * c + 3] = v.w;
        }
    }
#pragma unroll
    for (int c = 0; c < KS / 4; ++c) {
        uint4 hi, lo;
        split_tf32(x[4 * c], hi.x, lo.x);
        split_tf32(x[4 * c + 1], hi.y, lo.y);
        split_tf32(x[4 * c + 2], hi.z, lo.z);
        split_tf32(x[4 * c + 3], hi.w, lo.w);
        *reinterpret_cast<uint4*>(sp + swz(n, c)) = hi;
        *reinterpret_cast<uint4*>(sp + swz(n, KS / 4 + c)) = lo;
    }
    // A: rows r, r + 8 (r = the fragment row of lane / 4), k = 8 j + l % 4
    // (+ 4) of this half.
    const int kq = threadIdx.x & 3;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int m = r + 8 * (e & 1);
        const int k = KS * h + 8 * (e >> 2) + kq + 4 * ((e >> 1) & 1);
        const float v =
            A_MN ? *reinterpret_cast<const float*>(
                       a + (m >> 5) * 4096 + swz(k, (m & 31) >> 2) +
                       (m & 3) * 4)
                 : *reinterpret_cast<const float*>(a + swz(m, k >> 2) +
                                                   (k & 3) * 4);
        split_tf32(v, ah[e], al[e]);
    }
}

// The six TF32 products of a half stage on the accumulator: per k8 step,
// lo(A) hi(B) and hi(A) lo(B) first, then hi(A) hi(B) (the small terms
// join the sum before the large one; lo(A) lo(B), ~2^-22 relative, is
// dropped).  Fragments ah / al: k8 step j in elements 4 j .. 4 j + 3.
__device__ __forceinline__ void tf32x3_mma(float (&acc)[128],
                                           const uint32_t (&ah)[8],
                                           const uint32_t (&al)[8],
                                           const uint8_t* sp) {
    const uint32_t b = smem_u32(sp);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const uint64_t bhi = make_desc(b + 32 * j, 0, 1024);
        const uint64_t blo = make_desc(b + 64 + 32 * j, 0, 1024);
        wgmma_m64n256k8_tf32(acc, al + 4 * j, bhi);
        wgmma_m64n256k8_tf32(acc, ah + 4 * j, blo);
        wgmma_m64n256k8_tf32(acc, ah + 4 * j, bhi);
    }
    wgmma_commit();
}

// acc += the stages' A B in 3xTF32, k in order.  Half stage u (k 16 u ..
// 16 u + 15 of the call's slice) runs on split tile u % 2 and fragment
// set u % 2: while the tensor cores take half u, the consumers split half
// u + 1 into the other tile and set; then both warpgroups wait for their
// products and meet (the other tile is rewritten only after both are
// done with it).  Each consumer warp frees a ring stage once it has
// split both halves.  (Waiting only for half u - 1 instead, with a
// second meeting before the split, ran slower on the H100.)
// The tensor cores round each product's sum into the accumulator toward
// zero, so their error grows with the length of the sum, ~1e-5 of the
// largest output at 1024 k (chip_smoke.py's f32 yardstick) and past the
// gradient bound over a dW slice of 81,920 rows.  So every FLUSH_STAGES
// stages `flush` moves acc into the launch's f32 output with f32 adds
// (round to nearest) and zeroes it: no tensor-core sum is longer than
// 2048 k.
template <bool A_MN, bool B_MN, typename Flush>
__device__ __forceinline__ void tf32x3_main_loop(float (&acc)[128],
                                                 uint8_t* ring,
                                                 uint64_t* full,
                                                 uint64_t* empty, int nk,
                                                 int r, int lane,
                                                 Flush&& flush) {
    uint8_t* split = ring + STAGES_F32 * STAGE_BYTES;
    uint32_t ah0[8], al0[8], ah1[8], al1[8];
    if (nk == 0) return;
    mbar_wait(&full[0], 0);
    tf32x3_prep<A_MN, B_MN>(ring, 0, split, r, ah0, al0);
    fence_view_async();
    consumer_bar();
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES_F32;
        const uint8_t* a = ring + s * STAGE_BYTES;
        tf32x3_mma(acc, ah0, al0, split);
        tf32x3_prep<A_MN, B_MN>(a, 1, split + SPLIT_BYTES, r, ah1, al1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        fence_view_async();
        wgmma_wait<0>();
        fence_acc(acc);
        consumer_bar();
        tf32x3_mma(acc, ah1, al1, split + SPLIT_BYTES);
        if (kt + 1 < nk) {
            const int s1 = (kt + 1) % STAGES_F32;
            mbar_wait(&full[s1], ((kt + 1) / STAGES_F32) & 1);
            tf32x3_prep<A_MN, B_MN>(ring + s1 * STAGE_BYTES, 0, split, r,
                                    ah0, al0);
            fence_view_async();
        }
        wgmma_wait<0>();
        fence_acc(acc);
        consumer_bar();
        if ((kt + 1) % FLUSH_STAGES == 0 && kt + 1 < nk) flush();
    }
}

// An element of the operand type from f32 (bf16: round to nearest even).
__device__ __forceinline__ void put(bf16* p, float v) {
    *p = __float2bfloat16(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int FORM, int EPI, int ZF32, int F32>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_chain_kernel(const __grid_constant__ Params p) {
    // The f32 kernels read the stage's z from device memory (LN_BWD).
    static_assert(!F32 || EPI != LN_BWD || ZF32, "f32 z");
    using OutT = typename std::conditional<F32 != 0, float, bf16>::type;
    extern __shared__ uint8_t smem_raw[];
    // 1024-byte aligned (128-byte swizzle atoms); pointer arithmetic on the
    // shared array keeps every access below a known shared-memory one.
    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    float* red = reinterpret_cast<float*>(ring + AREA_BYTES);
    uint64_t* full = reinterpret_cast<uint64_t*>(red + RED_FLOATS);
    uint64_t* empty = full + STAGES;
    constexpr bool A_MN = FORM == DW;
    constexpr bool B_MN = FORM != DH;
    constexpr int SYNCS = EPI == LN_FWD ? 3 : (EPI == LN_BWD ? 4 : 0);
    constexpr int KB = F32 ? BK_F32 : BK;           // depth of a stage
    constexpr int NS = F32 ? STAGES_F32 : STAGES;   // ring stages
    constexpr int MNB = F32 ? 32 : 64;              // MN-major box width
    constexpr int BOX_BYTES = MNB * KB * (F32 ? 4 : 2);

    const int wg = threadIdx.x / 128;
    const int m0 = EPI == POOL ? (blockIdx.y / p.tiles) * p.rows +
                                     (blockIdx.y % p.tiles) * BM
                               : blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int kbeg = FORM == DW ? blockIdx.z * p.ksplit : 0;
    const int kend = FORM == DW ? min(p.K, kbeg + p.ksplit) : p.K;
    const int nk = kend > kbeg ? (kend - kbeg + KB - 1) / KB : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMERS * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (wg == CONSUMERS) {
        // ------------------------------------------------------ producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (threadIdx.x == CONSUMERS * 128) {
            for (int kt = 0; kt < nk; ++kt) {
                const int s = kt % NS;
                mbar_wait(&empty[s], ((kt / NS) & 1) ^ 1);
                mbar_expect_tx(&full[s], STAGE_BYTES);
                const int k0 = kbeg + kt * KB;
                uint8_t* a = ring + s * STAGE_BYTES;
                uint8_t* b = a + A_BYTES;
                if (A_MN) {
#pragma unroll
                    for (int j = 0; j < BM / MNB; ++j)
                        tma_load(a + j * BOX_BYTES, &p.ta, &full[s],
                                 m0 + MNB * j, k0);
                } else {
                    tma_load(a, &p.ta, &full[s], k0, m0);
                }
                if (B_MN) {
#pragma unroll
                    for (int j = 0; j < BN / MNB; ++j)
                        tma_load(b + j * BOX_BYTES, &p.tb, &full[s],
                                 n0 + MNB * j, k0);
                } else {
                    tma_load(b, &p.tb, &full[s], k0, n0);
                }
            }
        }
        __syncwarp();
        for (int i = 0; i + 1 < SYNCS; ++i) cluster_sync();
        if (SYNCS > 0) cluster_sync_last();
        return;
    }

    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x & 31;
    const int M = p.M, N = p.N;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    // Fragment coordinates: tile rows r, r + 8; columns 8 j + 2 q (+1).
    const int q = lane & 3;
    const int r = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);

    // STORE: acc (+ bias) to C.  In f32, a flush (see tf32x3_main_loop)
    // parks acc in the launch's own f32 output of the tile's shape (C;
    // H for LN_FWD; DZ for LN_BWD; the features for POOL, which then needs
    // them), first adding what the earlier flushes left there, 32 loads in
    // flight at a time; the epilogue adds the parked sum back to acc, so
    // every form sums a K the same way (K1's features stay K5's).
    float* const park =
        EPI == STORE ? p.C + (FORM == DW ? blockIdx.z * p.c_split : 0)
        : EPI == LN_FWD ? static_cast<float*>(p.H)
        : EPI == LN_BWD ? static_cast<float*>(p.DZ)
                        : p.C;
    const int ldp = EPI == LN_FWD ? p.ldh : (EPI == LN_BWD ? p.lddz : p.ldc);
    // POOL: only the cloud's rows of the tile (the box runs past its end).
    const int prow = EPI == POOL
                         ? min(BM, p.rows - (int)(blockIdx.y % p.tiles) * BM)
                         : BM;
    const bool rv[2] = {m0 + r < M && r < prow,
                        m0 + r + 8 < M && r + 8 < prow};
    auto store_acc = [&](bool with_bias) {
        const bool aligned = ((ldp | (int)(p.c_split & 1)) & 1) == 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int c = n0 + 8 * j + 2 * q;
            if (c >= N) continue;
            const bool pair = c + 1 < N;
            float b0 = 0.0f, b1 = 0.0f;
            if (with_bias && p.bias != nullptr) {
                b0 = p.bias[c];
                b1 = pair ? p.bias[c + 1] : 0.0f;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (rv[h])
                    store_f32x2(park + (size_t)(m0 + r + 8 * h) * ldp + c,
                                acc[4 * j + 2 * h] + b0,
                                acc[4 * j + 2 * h + 1] + b1, pair, aligned);
        }
    };
    auto add_c = [&]() {
#pragma unroll
        for (int jb = 0; jb < 32; jb += 8) {
            float old[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int j = jb + i / 4, h = (i / 2) & 1, e = i & 1;
                const int c = n0 + 8 * j + 2 * q + e;
                old[i] = rv[h] && c < N
                             ? park[(size_t)(m0 + r + 8 * h) * ldp + c]
                             : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[4 * jb + i] += old[i];
        }
    };
    bool flushed = false;

    if constexpr (F32) {
        tf32x3_main_loop<A_MN, B_MN>(
            acc, ring, full, empty, nk, r, lane, [&]() {
                if (flushed) add_c();
                store_acc(false);
                flushed = true;
#pragma unroll
                for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
            });
    } else {
        for (int kt = 0; kt < nk; ++kt) {
            const int s = kt % STAGES;
            mbar_wait(&full[s], (kt / STAGES) & 1);
            const uint32_t a =
                smem_u32(ring + s * STAGE_BYTES) + wg * (A_BYTES / 2);
            const uint32_t b = smem_u32(ring + s * STAGE_BYTES + A_BYTES);
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t da =
                    A_MN ? make_desc(a + kk * 2048, A_BYTES / 2, 1024)
                         : make_desc(a + kk * 32, 0, 1024);
                const uint64_t db =
                    B_MN ? make_desc(b + kk * 2048, B_BYTES / 4, 1024)
                         : make_desc(b + kk * 32, 0, 1024);
                wgmma_m64n256k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
            }
            wgmma_commit();
            wgmma_wait<1>();
            fence_acc(acc);
            if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (nk > 0 && lane == 0) mbar_arrive(&empty[(nk - 1) % STAGES]);
    }


    if (flushed) add_c();

    if (EPI == STORE) {
        store_acc(true);
        return;
    }

    if (EPI == POOL) {
        float* tile = reinterpret_cast<float*>(ring);
        const int r0 = (blockIdx.y % p.tiles) * BM;    // cloud row of row 0
        const int nrows = min(BM, p.rows - r0);
        consumer_bar();             // both warpgroups are done with the ring
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int c = n0 + 8 * j + 2 * q;
            const float b0 = c < N ? p.bias[c] : 0.0f;
            const float b1 = c + 1 < N ? p.bias[c + 1] : 0.0f;
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *reinterpret_cast<float2*>(tile + (r + 8 * h) * TILE_LD +
                                           8 * j + 2 * q) =
                    make_float2(acc[4 * j + 2 * h] + b0,
                                acc[4 * j + 2 * h + 1] + b1);
        }
        const int t = threadIdx.x;                      // tile column t
        if (t < BM) red[t] = t < nrows && p.valid[m0 + t] ? 1.0f : 0.0f;
        consumer_bar();
        const int c = n0 + t;
        if (c >= N) return;
        const int kvp = p.kv != nullptr ? p.kvp : 0;
        int wend = kvp ? (r0 / kvp + 1) * kvp : 0;      // past this window
        float msum = 0.0f, mmax = NEG_SENTINEL, usum = 0.0f;
        float umax = NEG_SENTINEL, cnt = 0.0f, wmax = NEG_SENTINEL;
        for (int i = 0; i < nrows; ++i) {
            const float f = tile[i * TILE_LD + t];
            usum += f;
            umax = fmaxf(umax, f);
            if (red[i] != 0.0f) {
                msum += f;
                mmax = fmaxf(mmax, f);
                cnt += 1.0f;
                wmax = fmaxf(wmax, f);
            }
            if (p.C != nullptr) p.C[(size_t)(m0 + i) * p.ldc + c] = f;
            if (kvp && (r0 + i + 1 == wend || i + 1 == nrows)) {
                const int wstart = wend - kvp;
                if (wstart >= r0 && wend <= r0 + nrows)
                    p.kv[((size_t)(blockIdx.y / p.tiles) * (p.rows / kvp) +
                          wstart / kvp) * N + c] =
                        wmax > NEG_SENTINEL / 2 ? wmax : 0.0f;
                else
                    p.edge[((size_t)blockIdx.y * 2 + (wstart < r0 ? 0 : 1)) *
                               N + c] = wmax;
                wmax = NEG_SENTINEL;
                wend += kvp;
            }
        }
        float* out = p.pool + (size_t)blockIdx.y * 5 * N + c;
        out[0] = msum;
        out[N] = mmax;
        out[2 * N] = usum;
        out[3 * N] = umax;
        out[4 * N] = cnt;
        return;
    }

    // LayerNorm epilogues: the accumulator into the f32 tile, then rows.
    float* tile = reinterpret_cast<float*>(ring);
    bf16* ztile = reinterpret_cast<bf16*>(ring + ZTILE);
    consumer_bar();                 // both warpgroups are done with the ring
    if (EPI == LN_BWD && !ZF32) {
        // The bf16 stash tile into shared memory, in flight while the
        // accumulator is written out; zero past the ragged edges.
        const bf16* Z = static_cast<const bf16*>(p.Z);
#pragma unroll
        for (int i = 0; i < BM * BN / 8 / (CONSUMERS * 128); ++i) {
            const int chunk = threadIdx.x + i * CONSUMERS * 128;
            const int rt = chunk / (BN / 8), ct = 8 * (chunk % (BN / 8));
            const int row = m0 + rt, col = n0 + ct;
            const int bytes = row < M && col < N ? 2 * min(8, N - col) : 0;
            cp_async16(ztile + rt * ZT_LD + ct,
                       bytes ? Z + (size_t)row * p.ldz + col : Z, bytes);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(tile + (r + 8 * h) * TILE_LD + 8 * j +
                                       2 * q) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    if (EPI == LN_BWD && !ZF32)
        asm volatile("cp.async.wait_group 0;" ::: "memory");
    consumer_bar();
    const int v = threadIdx.x >> 5;         // rows 16 v .. 16 v + 15
    const int c0 = n0 + 4 * lane;           // columns c0 + col(e)
    const float inv_n = 1.0f / (float)N;
    float gam[8], bet[8];            // 0 past column N
    load8(p.gamma, c0, N, true, gam);
    load8(p.beta, c0, N, true, bet);
    bool cv[8];                      // the lane's columns that exist
#pragma unroll
    for (int e = 0; e < 8; ++e) cv[e] = c0 + col(e) < N;
    auto tile_row = [&](int i, float (&x)[8]) {
        const float* t = tile + (16 * v + i) * TILE_LD + 4 * lane;
        const float4 a = *reinterpret_cast<const float4*>(t);
        const float4 b = *reinterpret_cast<const float4*>(t + BN / 2);
        x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
        x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    };

    if (EPI == LN_FWD) {
        float bias[8];
        load8(p.bias, c0, N, true, bias);
        // z = acc + b on the stage's columns, 0 beyond.
        auto z_row = [&](int i, float (&z)[8]) {
            tile_row(i, z);
#pragma unroll
            for (int e = 0; e < 8; ++e) z[e] = cv[e] ? z[e] + bias[e] : 0.0f;
        };
        float mean[1] = {0.0f};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            float z[8];
            z_row(i, z);
            float s = 0.0f;
#pragma unroll
            for (int e = 0; e < 8; ++e) s += z[e];
            s = warp_sum(s);
            mean[0] = lane == i ? s : mean[0];
        }
        cluster_rows<1>(mean, red, v, lane);
        mean[0] = mean[0] / (float)N;
        float var[1] = {0.0f};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            float z[8];
            z_row(i, z);
            const float mu = bcast(mean[0], i);
            float s = 0.0f;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float d = z[e] - mu;
                s += cv[e] ? d * d : 0.0f;
            }
            s = warp_sum(s);
            var[0] = lane == i ? s : var[0];
        }
        cluster_rows<1>(var, red + BM, v, lane);
        const float rstd_l = rsqrtf(var[0] / (float)N + 1e-6f);
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
            const float mu = bcast(mean[0], i);
            const float rstd = bcast(rstd_l, i);
            const int row = m0 + 16 * v + i;
            if (row >= M) continue;          // the same for the whole warp
            float z[8], h[8];
            z_row(i, z);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                h[e] = fmaxf((z[e] - mu) * rstd * gam[e] + bet[e], 0.0f);
            store8(static_cast<OutT*>(p.H) + (size_t)row * p.ldh, c0, N, h);
            if (p.Z != nullptr) {
                if (p.z_f32)
                    store8(static_cast<float*>(p.Z) + (size_t)row * p.ldz, c0,
                           N, z);
                else
                    store8(static_cast<bf16*>(p.Z) + (size_t)row * p.ldz, c0,
                           N, z);
            }
        }
        cluster_sync_last();
        return;
    }

    // LN_BWD: the tile holds dh.  z rows come from the stash tile in
    // shared memory (bf16, K3) or from the recomputed f32 z in device
    // memory (K5: an f32 tile does not fit beside dh).
    auto z_row = [&](int i, float (&z)[8]) {
        if (ZF32) {
            const int row = m0 + 16 * v + i;
            load8(static_cast<const float*>(p.Z) +
                      (size_t)(row < M ? row : 0) * p.ldz,
                  c0, N, row < M, z);
        } else {
            load8(ztile + (16 * v + i) * ZT_LD, 4 * lane, BN, true, z);
        }
    };
    float mean[1] = {0.0f};
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
        float z[8];
        z_row(i, z);
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s += z[e];
        s = warp_sum(s);
        mean[0] = lane == i ? s : mean[0];
    }
    cluster_rows<1>(mean, red, v, lane);
    mean[0] = mean[0] / (float)N;
    float var[1] = {0.0f};
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
        float z[8];
        z_row(i, z);
        const float mu = bcast(mean[0], i);
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float d = z[e] - mu;
            s += cv[e] ? d * d : 0.0f;
        }
        s = warp_sum(s);
        var[0] = lane == i ? s : var[0];
    }
    cluster_rows<1>(var, red + BM, v, lane);
    const float rstd_l = rsqrtf(var[0] / (float)N + 1e-6f);

    // The ReLU backward with jnp.maximum's tie rule and the LayerNorm
    // backward to dxhat (written back over dh); row sums of dxhat and
    // dxhat * xhat; this lane's d gamma / d beta columns.  No global store
    // before the exchange: its release would wait for them to drain.
    // No masks: past column N gamma is 0 (so dxhat is), and a row past M
    // has z = 0 and dh = 0 (zero-filled), so xhat = dln = dxhat = 0 there
    // and, in the next pass, dz = 0; columns past N are never written.
    float cg[8], cb[8], cz[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) cg[e] = cb[e] = cz[e] = 0.0f;
    float s12[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
        const float mu = bcast(mean[0], i);
        const float rstd = bcast(rstd_l, i);
        float z[8], g[8];
        z_row(i, z);
        tile_row(i, g);
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float xhat = (z[e] - mu) * rstd;
            const float ln = xhat * gam[e] + bet[e];
            const float dln =
                ln > 0.0f ? g[e] : (ln < 0.0f ? 0.0f : 0.5f * g[e]);
            const float dxhat = dln * gam[e];
            g[e] = dxhat;
            s1 += dxhat;
            s2 += dxhat * xhat;
            cg[e] += dln * xhat;
            cb[e] += dln;
        }
        float* t = tile + (16 * v + i) * TILE_LD + 4 * lane;
        *reinterpret_cast<float4*>(t) = make_float4(g[0], g[1], g[2], g[3]);
        *reinterpret_cast<float4*>(t + BN / 2) =
            make_float4(g[4], g[5], g[6], g[7]);
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        s12[0] = lane == i ? s1 : s12[0];
        s12[1] = lane == i ? s2 : s12[1];
    }
    cluster_rows<2>(s12, red + 2 * BM, v, lane);
    const float m1_l = s12[0] * inv_n, m2_l = s12[1] * inv_n;

    // dz = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd, and h
    // rebuilt (K3).
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
        const float mu = bcast(mean[0], i);
        const float rstd = bcast(rstd_l, i);
        const float m1 = bcast(m1_l, i), m2 = bcast(m2_l, i);
        const int row = m0 + 16 * v + i;
        float z[8], dx[8], dz[8], hv[8];
        z_row(i, z);
        tile_row(i, dx);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float xhat = (z[e] - mu) * rstd;
            hv[e] = fmaxf(xhat * gam[e] + bet[e], 0.0f);
            dz[e] = (dx[e] - m1 - xhat * m2) * rstd;
            cz[e] += dz[e];
        }
        if (row < M && c0 < N) {
            store8(static_cast<OutT*>(p.DZ) + (size_t)row * p.lddz, c0, N,
                   dz);
            if (p.H != nullptr)
                store8(static_cast<OutT*>(p.H) + (size_t)row * p.ldh, c0, N,
                       hv);
        }
    }
    // Column partials: this warp's 16 rows, then the 8 warps in order
    // (over the dh tile, once every warp is done with it).
    float* colbuf = tile;
    consumer_bar();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        colbuf[(0 * 8 + v) * BN + 4 * lane + col(e)] = cg[e];
        colbuf[(1 * 8 + v) * BN + 4 * lane + col(e)] = cb[e];
        colbuf[(2 * 8 + v) * BN + 4 * lane + col(e)] = cz[e];
    }
    consumer_bar();
    const int t = threadIdx.x;      // tile column t
    if (n0 + t < N) {
        float* out = p.part + (size_t)blockIdx.y * 3 * N + n0 + t;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < 8; ++w) s += colbuf[(k * 8 + w) * BN + t];
            out[k * N] = s;
        }
    }
    cluster_sync_last();
}

// The chain's first operand: xb[r, :ldx] = X[r, :D] in the operand type
// (bf16 as x.astype(bf16), or f32) then zeros, rows padded for TMA;
// valid[r] = |sum_d X[r, d]| > 1e-9, the encoder's validity mask from the
// RAW f32 row (null: skip).
template <typename T>
__global__ void prep_x_kernel(const float* __restrict__ X, int D,
                              T* __restrict__ xb, int ldx,
                              uint8_t* __restrict__ valid, int M) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= M) return;
    const float* xr = X + (size_t)r * D;
    float s = 0.0f;
    for (int d = 0; d < D; ++d) {
        s += xr[d];
        put(xb + (size_t)r * ldx + d, xr[d]);
    }
    for (int d = D; d < ldx; ++d) put(xb + (size_t)r * ldx + d, 0.0f);
    if (valid != nullptr) valid[r] = fabsf(s) > 1e-9f ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------

template <typename T>
inline int prep_x(const float* X, int D, T* xb, int ldx, uint8_t* valid,
                  int M, cudaStream_t stream) {
    if (ldx < D || ldx % 8) return (int)cudaErrorInvalidValue;
    prep_x_kernel<<<(M + 255) / 256, 256, 0, stream>>>(X, D, xb, ldx, valid,
                                                      M);
    return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                    cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
    return fn;
}

struct MapKey {
    const void* ptr;
    unsigned long long inner, outer, ld;
    unsigned box0, box1, f32;
};

// A 2-D map of a row-major (outer, inner) array with row stride `ld`
// elements, box (box0 inner, box1 outer), 128-byte swizzle, zero fill.
// Maps are cached: a steady training loop finds its buffers at the same
// addresses step after step.
inline int tensor_map(CUtensorMap* out, const void* ptr, bool f32,
                      long long inner, long long outer, long long ld,
                      int box0, int box1) {
    constexpr int SLOTS = 64;
    static MapKey keys[SLOTS];
    static CUtensorMap maps[SLOTS];
    static int used = 0, next = 0;
    MapKey key;
    memset(&key, 0, sizeof key);
    key.ptr = ptr;
    key.inner = inner;
    key.outer = outer;
    key.ld = ld;
    key.box0 = box0;
    key.box1 = box1;
    key.f32 = f32;
    for (int i = 0; i < used; ++i)
        if (memcmp(&keys[i], &key, sizeof key) == 0) {
            *out = maps[i];
            return 0;
        }
    const int esize = f32 ? 4 : 2;
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 ||
        (ld * esize) % 16 || inner < 1 || outer < 1 || ld < inner)
        return (int)cudaErrorInvalidValue;
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
    const cuuint64_t strides[1] = {(cuuint64_t)(ld * esize)};
    const cuuint32_t box[2] = {(cuuint32_t)box0, (cuuint32_t)box1};
    const cuuint32_t unit[2] = {1, 1};
    CUtensorMap map;
    const CUresult res = fn(
        &map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        2, const_cast<void*>(ptr), dims, strides, box, unit,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    keys[next] = key;
    maps[next] = map;
    next = (next + 1) % SLOTS;
    used = used < SLOTS ? used + 1 : SLOTS;
    *out = map;
    return 0;
}

// Maps of the two operands for a form.  A: (M, K) K-major with row stride
// lda, or (K, M) MN-major for DW; B: (K, N) MN-major with row stride ldb,
// or (N, K) K-major for DH; bf16, or f32 (f32: boxes 32 deep, 128 bytes
// like bf16's 64).
inline int operand_maps(Params& p, int form, const void* A, int lda,
                        const void* B, int ldb, bool f32) {
    const int kb = f32 ? BK_F32 : BK, mnb = f32 ? 32 : 64;
    int err = form == DW
                  ? tensor_map(&p.ta, A, f32, p.M, p.K, lda, mnb, kb)
                  : tensor_map(&p.ta, A, f32, p.K, p.M, lda, kb, BM);
    if (err) return err;
    return form == DH ? tensor_map(&p.tb, B, f32, p.K, p.N, ldb, kb, BN)
                      : tensor_map(&p.tb, B, f32, p.N, p.K, ldb, mnb, kb);
}

template <int FORM, int EPI, int ZF32, int F32>
inline int launch(const Params& p, int splits, cudaStream_t stream) {
    auto kernel = wgmma_chain_kernel<FORM, EPI, ZF32, F32>;
    static bool ready = false;
    if (!ready) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        ready = true;
    }
    const int ntiles = (p.N + BN - 1) / BN;
    cudaLaunchConfig_t cfg;
    memset(&cfg, 0, sizeof cfg);
    cfg.gridDim = dim3(ntiles,
                       EPI == POOL ? p.M / p.rows * p.tiles
                                   : (p.M + BM - 1) / BM,
                       splits);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = EPI == STORE || EPI == POOL ? 1 : ntiles;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// C = op(A) op(B) (+ bias, FWD only), f32, row stride ldc; operands bf16,
// or f32 (f32).  DW: `splits` K-slices of ksplit rows (a multiple of the
// stage depth) write partials at C + s * M * ldc.
inline int gemm_store(int form, const void* A, int lda, const void* B,
                      int ldb, const float* bias, float* C, int ldc, int M,
                      int N, int K, int splits, int ksplit, bool f32,
                      cudaStream_t stream) {
    if (M < 1 || N < 1 || K < 1 || ldc < N || splits < 1 ||
        (form != DW && splits != 1) || (form != FWD && bias != nullptr) ||
        (splits > 1 && (ksplit % (f32 ? BK_F32 : BK) ||
                        (long long)ksplit * splits < K)))
        return (int)cudaErrorInvalidValue;
    Params p;
    memset(&p, 0, sizeof p);
    p.M = M;
    p.N = N;
    p.K = K;
    p.ksplit = splits > 1 ? ksplit : K;
    p.C = C;
    p.ldc = ldc;
    p.c_split = (long long)M * ldc;
    p.bias = bias;
    int err = operand_maps(p, form, A, lda, B, ldb, f32);
    if (err) return err;
    if (f32) {
        if (form == FWD) return launch<FWD, STORE, 0, 1>(p, 1, stream);
        if (form == DH) return launch<DH, STORE, 0, 1>(p, 1, stream);
        if (form == DW) return launch<DW, STORE, 0, 1>(p, splits, stream);
        return (int)cudaErrorInvalidValue;
    }
    if (form == FWD) return launch<FWD, STORE, 0, 0>(p, 1, stream);
    if (form == DH) return launch<DH, STORE, 0, 0>(p, 1, stream);
    if (form == DW) return launch<DW, STORE, 0, 0>(p, splits, stream);
    return (int)cudaErrorInvalidValue;
}

// One forward stage: z = A W + b (A (M, K), W (K, N), both bf16, or both
// f32 with f32), then H = relu(LayerNorm(z)) in the operand type, and Z =
// the bf16 stash or the f32 z (z_f32; the only z in f32) or nothing (null).
inline int gemm_ln_fwd(const void* A, int lda, const void* W, int ldw,
                       const float* bias, const float* gamma,
                       const float* beta, void* H, int ldh, void* Z, int ldz,
                       int z_f32, int M, int N, int K, bool f32,
                       cudaStream_t stream) {
    if (M < 1 || N < 1 || K < 1 || N > MAX_CLUSTER * BN || ldh < N ||
        (Z != nullptr && ldz < N) || ldh % 8 || (Z != nullptr && ldz % 8) ||
        (f32 && Z != nullptr && !z_f32))
        return (int)cudaErrorInvalidValue;
    Params p;
    memset(&p, 0, sizeof p);
    p.M = M;
    p.N = N;
    p.K = K;
    p.ksplit = K;
    p.bias = bias;
    p.gamma = gamma;
    p.beta = beta;
    p.H = H;
    p.ldh = ldh;
    p.Z = Z;
    p.ldz = ldz;
    p.z_f32 = z_f32;
    int err = operand_maps(p, FWD, A, lda, W, ldw, f32);
    if (err) return err;
    return f32 ? launch<FWD, LN_FWD, 0, 1>(p, 1, stream)
               : launch<FWD, LN_FWD, 0, 0>(p, 1, stream);
}

// One stage's backward: dh = A W^T (A = dz of the stage above, (M, K);
// W = the weight above, stored (N, K); both bf16, or both f32 with f32)
// in registers, then the LayerNorm / ReLU backward from Z (the bf16
// stash, or the f32 z when z_f32, the only z in f32): DZ and Hout (the
// rebuilt h; null: not written) in the operand type, and the column
// partials part[row tile][d gamma (N) | d beta (N) | d b (N)].
inline int gemm_ln_bwd(const void* A, int lda, const void* W, int ldw,
                       const void* Z, int ldz, int z_f32, const float* gamma,
                       const float* beta, void* DZ, int lddz, void* Hout,
                       int ldh, float* part, int M, int N, int K, bool f32,
                       cudaStream_t stream) {
    if (M < 1 || N < 1 || K < 1 || N > MAX_CLUSTER * BN || lddz < N ||
        lddz % 8 || (Hout != nullptr && (ldh < N || ldh % 8)) ||
        Z == nullptr || reinterpret_cast<uintptr_t>(Z) % 16 || ldz < N ||
        ldz % 8 || (f32 && !z_f32))
        return (int)cudaErrorInvalidValue;
    Params p;
    memset(&p, 0, sizeof p);
    p.M = M;
    p.N = N;
    p.K = K;
    p.ksplit = K;
    p.gamma = gamma;
    p.beta = beta;
    p.H = Hout;
    p.ldh = ldh;
    p.DZ = DZ;
    p.lddz = lddz;
    p.part = part;
    p.Z = const_cast<void*>(Z);
    p.ldz = ldz;
    const int err = operand_maps(p, DH, A, lda, W, ldw, f32);
    if (err) return err;
    if (f32) return launch<DH, LN_BWD, 1, 1>(p, 1, stream);
    return z_f32 ? launch<DH, LN_BWD, 1, 0>(p, 1, stream)
                 : launch<DH, LN_BWD, 0, 0>(p, 1, stream);
}

// The point encoder's projection: f = A W + b for `clouds` clouds of
// `rows` rows (A (clouds * rows, K), W (K, N), both bf16 or both f32 with
// f32), pooled per
// (cloud, 128-row tile) into pool; kv window maxima over kvp rows (kv
// null: none), with the partials of windows that cross a tile boundary in
// edge (needed when kvp does not divide 128 and a cloud has two tiles or
// more); F (f32, row stride ldf) the features when not null (needed in
// f32 when K > 2048: the flushes park their sums there).
inline int gemm_pool(const void* A, int lda, const void* W, int ldw,
                     const float* bias, const uint8_t* valid, float* F,
                     int ldf, float* pool, float* kv, float* edge, int kvp,
                     int clouds, int rows, int N, int K, bool f32,
                     cudaStream_t stream) {
    const int tiles = (rows + BM - 1) / BM;
    // f32 past FLUSH_STAGES stages parks its partial sums in F.
    if (clouds < 1 || rows < 1 || N < 1 || K < 1 || bias == nullptr ||
        valid == nullptr || pool == nullptr || (F != nullptr && ldf < N) ||
        (f32 && F == nullptr && K > FLUSH_STAGES * BK_F32) ||
        (kv != nullptr &&
         (kvp < 1 || rows % kvp ||
          (edge == nullptr && tiles > 1 && BM % kvp != 0))))
        return (int)cudaErrorInvalidValue;
    Params p;
    memset(&p, 0, sizeof p);
    p.M = clouds * rows;
    p.N = N;
    p.K = K;
    p.ksplit = K;
    p.bias = bias;
    p.C = F;
    p.ldc = ldf;
    p.valid = valid;
    p.pool = pool;
    p.kv = kv;
    p.edge = edge;
    p.rows = rows;
    p.tiles = tiles;
    p.kvp = kvp;
    const int err = operand_maps(p, FWD, A, lda, W, ldw, f32);
    if (err) return err;
    return f32 ? launch<FWD, POOL, 0, 1>(p, 1, stream)
               : launch<FWD, POOL, 0, 0>(p, 1, stream);
}

}  // namespace
}  // namespace hgemm
