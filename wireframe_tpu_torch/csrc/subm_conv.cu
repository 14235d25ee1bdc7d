// Submanifold sparse convolution at inference (Point Transformer V3's stem
// and xCPE convs), hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no PTv3.  It was added
// because the eager form (models/ptv3.py's SubMConv before it: a row
// gather of every (row, offset) slot into a (rows, K * CIN) copy, then one
// GEMM) spent ~110 of a ~276 ms batch-128 call in PyTorch's row gathers,
// which read ~1.66 G indices/s whatever the row width.  For the M packed
// rows of one level, K = size^3 offsets and the level's map NBR (M, K)
// (the packed row of the voxel at each offset, M where there is none):
//
//   y[r] = sum_o W_o x[NBR[r, o]] + b          W_o: (COUT, CIN) of W
//
// with W (COUT, K * CIN), the offsets' input channels side by side, as the
// module holds it.  bf16 operands, one f32 sum in the offsets' order, the
// bias added in f32, one rounding to bf16 at the end; no float atomics.
//
// What bounds it on this card: bytes.  At the benchmark's batch-128 call
// the 23 convolutions read each level's input rows once, its map at 4
// bytes a slot (the int64 map this kernel reads takes 8), the weights,
// and write the outputs once: ~1.7 GB, ~0.5 ms at 3.35 TB/s; the pairs that exist are
// ~0.19 TFLOP (~0.2 ms at the bf16 peak).  The design keeps the gathered
// rows out of device memory:
//   - A block owns a tile of BM output rows x BN output channels.  It
//     first loads its slice of the map (BM x K, int64 -> int32 in shared
//     memory; M and rows past M become -1).
//   - Offsets no row of the tile uses are found from the map with warp
//     votes and skipped; the rest become a list of depth chunks (KC deep
//     along K * CIN).  A tile of dummy rows only (the level sorts them
//     last and their map rows name only M) runs no chunk: it writes the
//     bias and stops.
//   - Each chunk's A tile (BM gathered rows x KC) and B tile (BN weight
//     rows x KC) come through a ring of 3 stages by 16-byte cp.async; an
//     empty slot's copy has src-size 0, which zero-fills without reading.
//     At CIN = 8 (the stem) a 16-deep chunk holds two offsets, so 125
//     offsets take 63 steps.
//   - Products on mma.sync m16n8k16 (bf16, f32 accumulate), 4 warps.
//     Not wgmma: the dense work is ~1 TFLOP a call on tiles of 64-128
//     rows whose A operand is gathered row by row into shared memory;
//     the kernel waits on those gathers, not on the tensor cores, and
//     mma.sync reads the padded, conflict-free layout cp.async writes
//     (wgmma would need its swizzled layout built by the gather).
//   - Small levels split COUT over blocks (BN = 128 for COUT >= 128), so
//     stage 4 (3,992 rows at COUT 512) still gives 252 blocks for 132 SMs.
//   - The outputs go through shared memory to 16-byte stores.
//   - Each block adds its (block, offset) steps run and skipped to two
//     int64 counters with one integer atomicAdd each.
//
// Host side: plain C interface (ops/subm_conv.py loads it with ctypes);
// (CIN, COUT) in {(8, 32), (32, 32), (64, 64), (128, 128), (256, 256),
// (512, 512)}, K <= 125.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;         // chunks in the ring
constexpr int PAD = 8;            // bf16 elements of padding a shared row
constexpr int MAX_K = 125;        // offsets: size 5
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have

struct Params {
    const bf16* x;                // (M, CIN)
    const long long* nbr;         // (M, K), M: no voxel
    const bf16* w;                // (COUT, K * CIN)
    const bf16* bias;             // (COUT) or null
    bf16* y;                      // (M, COUT)
    unsigned long long* counts;   // [steps run, steps skipped] or null
    int M, K, COUT, n_tiles;      // n_tiles: COUT / BN
};

__host__ __device__ constexpr int up16(int bytes) {
    return (bytes + 15) / 16 * 16;
}

template <int CIN_, int BM_, int BN_, int KC_, int WM_>
struct Tile {
    static constexpr int CIN = CIN_, BM = BM_, BN = BN_, KC = KC_;
    static constexpr int WM = WM_, WN = WARPS / WM_;
    static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
    static constexpr int MT = WTM / 16, NT = WTN / 8;
    static constexpr int LDS = KC + PAD;                  // ring rows
    static constexpr int A_ELEMS = BM * LDS, B_ELEMS = BN * LDS;
    static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
    static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
    static constexpr int LDO = BN + PAD;                  // output rows
    static constexpr int OUT_BYTES = BM * LDO * 2;
    static constexpr int REGION =
        up16(RING_BYTES > OUT_BYTES ? RING_BYTES : OUT_BYTES);
    static constexpr int SEG = KC / 8;                    // 16-byte pieces
    static_assert(CIN % KC == 0 || (CIN == 8 && KC == 16), "chunk depth");
    static_assert(WTM % 16 == 0 && NT % 2 == 0, "warp tile");
    static_assert((BM * SEG) % THREADS == 0, "A pieces a thread");

    // Depth chunks of K offsets.
    __host__ __device__ static constexpr int chunks(int k) {
        return (k * CIN + KC - 1) / KC;
    }
    // Shared memory: the ring (the output tile over it at the end), the
    // map slice, the used offsets, the chunk list and its length.
    __host__ __device__ static constexpr int map_off() { return REGION; }
    __host__ __device__ static constexpr int used_off(int k) {
        return REGION + up16(BM * k * 4);
    }
    __host__ __device__ static constexpr int list_off(int k) {
        return used_off(k) + up16(k * 4);
    }
    __host__ __device__ static constexpr int count_off(int k) {
        return list_off(k) + up16(chunks(k) * 4);
    }
    __host__ __device__ static constexpr int smem(int k) {
        return count_off(k) + 16;
    }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte copy, or 16 zero bytes with nothing read (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(read ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&t);
}

// Chunk `c` (depths [c KC, c KC + KC) of K * CIN) into ring stage `st`:
// the tile's gathered input rows and the weight rows n0 .. n0 + BN.
template <class T>
__device__ __forceinline__ void load_chunk(const Params& p, const int* map,
                                           bf16* ring, int c, int st, int n0,
                                           int tid) {
    bf16* As = ring + st * T::STAGE_ELEMS;
    bf16* Bs = As + T::A_ELEMS;
    const int d0 = c * T::KC, depth = p.K * T::CIN;
#pragma unroll
    for (int i = 0; i < T::BM * T::SEG / THREADS; ++i) {
        const int q = tid + i * THREADS;
        const int r = q / T::SEG, j = q % T::SEG;
        const int d = d0 + j * 8;
        const int o = d / T::CIN, ch = d % T::CIN;
        const int src = o < p.K ? map[r * p.K + o] : -1;
        cp_async16(As + r * T::LDS + j * 8,
                   p.x + (size_t)(src < 0 ? 0 : src) * T::CIN + ch, src >= 0);
    }
#pragma unroll
    for (int i = 0; i < (T::BN * T::SEG + THREADS - 1) / THREADS; ++i) {
        const int q = tid + i * THREADS;
        if (q >= T::BN * T::SEG) break;
        const int n = q / T::SEG, j = q % T::SEG;
        const int d = d0 + j * 8;
        cp_async16(Bs + n * T::LDS + j * 8,
                   p.w + (size_t)(n0 + n) * depth + (d < depth ? d : 0),
                   d < depth);
    }
}

template <class T>
__device__ __forceinline__ void mma_chunk(float (&acc)[T::MT][T::NT][4],
                                          const bf16* As, const bf16* Bs,
                                          int wm, int wn, int lane) {
#pragma unroll
    for (int ks = 0; ks < T::KC / 16; ++ks) {
        uint32_t a[T::MT][4];
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
            ldsm_x4(a[mt], As + (wm * T::WTM + mt * 16 + (lane & 15)) * T::LDS +
                               ks * 16 + (lane >> 4) * 8);
        uint32_t b[T::NT][2];
#pragma unroll
        for (int np = 0; np < T::NT / 2; ++np) {
            uint32_t r[4];
            ldsm_x4(r, Bs + (wn * T::WTN + np * 16 + (lane & 7) +
                             ((lane >> 4) << 3)) * T::LDS +
                           ks * 16 + ((lane >> 3) & 1) * 8);
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < T::NT; ++nt)
                mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
}

template <int CIN, int BM, int BN, int KC, int WM>
__global__ void __launch_bounds__(THREADS) subm_conv_kernel(const Params p) {
    using T = Tile<CIN, BM, BN, KC, WM>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int K = p.K;
    const int nch = T::chunks(K);
    bf16* ring = reinterpret_cast<bf16*>(smem);
    int* map = reinterpret_cast<int*>(smem + T::map_off());
    int* used = reinterpret_cast<int*>(smem + T::used_off(K));
    int* list = reinterpret_cast<int*>(smem + T::list_off(K));
    int* steps_s = reinterpret_cast<int*>(smem + T::count_off(K));

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / T::WN, wn = warp % T::WN;
    const int r0 = (int)(blockIdx.x / p.n_tiles) * BM;
    const int n0 = (int)(blockIdx.x % p.n_tiles) * BN;

    // The tile's slice of the map, coalesced: -1 for M and past row M.
    const long long base = (long long)r0 * K, end = (long long)p.M * K;
#pragma unroll 4
    for (int i = tid; i < BM * K; i += THREADS) {
        const long long v = base + i < end ? __ldg(p.nbr + base + i) : -1;
        map[i] = (v >= 0 && v < p.M) ? (int)v : -1;
    }
    __syncthreads();
    // The offsets some row of the tile uses: one vote a warp an offset.
    for (int o = warp; o < K; o += WARPS) {
        bool hit = false;
        for (int r = lane; r < BM; r += 32) hit |= map[r * K + o] >= 0;
        const int any = __any_sync(0xffffffffu, hit);
        if (lane == 0) used[o] = any;
    }
    __syncthreads();
    // The chunks that hold a used offset, in order; the block's counts.
    if (warp == 0) {
        int n = 0;
        for (int c0 = 0; c0 < nch; c0 += 32) {
            const int c = c0 + lane;
            bool act = false;
            if (c < nch) {
                const int lo = c * KC / CIN;
                const int hi = min(K - 1, ((c + 1) * KC - 1) / CIN);
                for (int o = lo; o <= hi; ++o) act |= used[o] != 0;
            }
            const unsigned bits = __ballot_sync(0xffffffffu, act);
            if (act) list[n + __popc(bits & ((1u << lane) - 1u))] = c;
            n += __popc(bits);
        }
        int ran = 0;
        for (int o = lane; o < K; o += 32) ran += used[o];
        ran = __reduce_add_sync(0xffffffffu, ran);
        if (lane == 0) {
            *steps_s = n;
            if (p.counts) {
                atomicAdd(p.counts, (unsigned long long)ran);
                atomicAdd(p.counts + 1, (unsigned long long)(K - ran));
            }
        }
    }
    __syncthreads();
    const int steps = *steps_s;

    float acc[T::MT][T::NT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < steps) load_chunk<T>(p, map, ring, list[s], s, n0, tid);
        cp_commit();
    }
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
        // Chunk s has landed; every warp is past chunk s - 1, whose stage
        // the chunk s + STAGES - 1 takes.
        cp_wait<STAGES - 2>();
        __syncthreads();
        const int nx = s + STAGES - 1;
        if (nx < steps)
            load_chunk<T>(p, map, ring, list[nx], nx % STAGES, n0, tid);
        cp_commit();
        const bf16* As = ring + (s % STAGES) * T::STAGE_ELEMS;
        mma_chunk<T>(acc, As, As + T::A_ELEMS, wm, wn, lane);
    }
    cp_wait<0>();
    __syncthreads();

    // Epilogue: + bias in f32, one rounding, through shared memory.
    bf16* out = ring;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
        const int col = wn * T::WTN + nt * 8 + 2 * tq;
        const float b0 = p.bias ? __bfloat162float(p.bias[n0 + col]) : 0.0f;
        const float b1 =
            p.bias ? __bfloat162float(p.bias[n0 + col + 1]) : 0.0f;
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
            const int row = wm * T::WTM + mt * 16 + g;
            *reinterpret_cast<uint32_t*>(out + row * T::LDO + col) =
                pack2(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
            *reinterpret_cast<uint32_t*>(out + (row + 8) * T::LDO + col) =
                pack2(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
        }
    }
    __syncthreads();
    constexpr int OSEG = BN / 8;
    for (int q = tid; q < BM * OSEG; q += THREADS) {
        const int r = q / OSEG, j = q % OSEG;
        if (r0 + r < p.M)
            *reinterpret_cast<uint4*>(p.y + (size_t)(r0 + r) * p.COUT + n0 +
                                      j * 8) =
                *reinterpret_cast<const uint4*>(out + r * T::LDO + j * 8);
    }
}

// The tile of each (CIN, COUT) the library is built for.
#define SUBM_SHAPES(X)                 \
    X(8, 32, 128, 32, 16, 4)           \
    X(32, 32, 128, 32, 32, 4)          \
    X(64, 64, 128, 64, 64, 4)          \
    X(128, 128, 64, 128, 64, 2)        \
    X(256, 256, 64, 128, 64, 2)        \
    X(512, 512, 64, 128, 64, 2)

template <int CIN, int BM, int BN, int KC, int WM>
int launch(Params p, cudaStream_t stream) {
    using T = Tile<CIN, BM, BN, KC, WM>;
    static_assert(T::smem(MAX_K) <= SMEM_LIMIT, "shared memory");
    auto kernel = subm_conv_kernel<CIN, BM, BN, KC, WM>;
    static int ready = -1;
    if (ready != 0 &&
        (ready = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             T::smem(MAX_K))) != 0)
        return ready;
    if (p.COUT % BN) return (int)cudaErrorInvalidValue;
    p.n_tiles = p.COUT / BN;
    const long long blocks = (long long)((p.M + BM - 1) / BM) * p.n_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, THREADS, T::smem(p.K), stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    return (int)e;
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// The tile at (CIN, COUT): 0 BM, 1 BN, 2 KC, 3 warps along the rows; -1
// for a width not built.  4: the largest K, whatever the width.
int subm_conv_tile(int cin, int cout, int which) {
    if (which == 4) return MAX_K;
#define SUBM_TILE(ci, co, bm, bn, kc, wm)            \
    if (cin == ci && cout == co) {                   \
        switch (which) {                             \
            case 0: return bm;                       \
            case 1: return bn;                       \
            case 2: return kc;                       \
            case 3: return wm;                       \
            default: return -1;                      \
        }                                            \
    }
    SUBM_SHAPES(SUBM_TILE)
#undef SUBM_TILE
    return -1;
}

// Y (M, COUT) = the submanifold convolution of X (M, CIN) bf16 over
// NBR (M, K) int64 (M: no voxel) with W (COUT, K * CIN) bf16 and BIAS
// (COUT) bf16 or null; COUNTS: two int64 (steps run, skipped) or null.
// All contiguous, X, W and Y 16-byte aligned.
int subm_conv(const void* X, const void* NBR, const void* W,
              const void* BIAS, void* Y, void* COUNTS, int M, int K, int CIN,
              int COUT, cudaStream_t stream) {
    if (M < 1 || K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
    if (!aligned16(X) || !aligned16(W) || !aligned16(Y))
        return (int)cudaErrorInvalidValue;
    Params p;
    p.x = static_cast<const bf16*>(X);
    p.nbr = static_cast<const long long*>(NBR);
    p.w = static_cast<const bf16*>(W);
    p.bias = static_cast<const bf16*>(BIAS);
    p.y = static_cast<bf16*>(Y);
    p.counts = static_cast<unsigned long long*>(COUNTS);
    p.M = M;
    p.K = K;
    p.COUT = COUT;
    p.n_tiles = 1;
#define SUBM_LAUNCH(ci, co, bm, bn, kc, wm) \
    if (CIN == ci && COUT == co) return launch<ci, bm, bn, kc, wm>(p, stream);
    SUBM_SHAPES(SUBM_LAUNCH)
#undef SUBM_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
