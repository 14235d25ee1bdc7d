// The edge head's pair MLP at inference, from the pair sum to the sigmoid,
// hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package leaves this tail of
// wireframe_tpu/models/edge_head.py (EdgePredictor.__call__, from
// PairDense's pair sum through the sigmoid) to XLA, which fuses it; run
// eagerly it is some twenty passes over a (B, E, F) tensor, E = V(V-1)/2
// pair rows a cloud.  For each pair row (b, e), (i, j) the e-th pair of
// the lexicographic upper-triangular table over the V slots:
//
//   y     = u_i[b,i] + u_j[b,j] + dist(x[b,i], x[b,j]) w_d + b_2    (F)
//   h1    = gelu(LayerNorm_2(y))
//   z3    = bf16(h1) W3^T + b3                                     (F/2)
//   h3    = gelu(LayerNorm_3(z3))
//   z4    = bf16(h3) W4^T + b4                                     (F/4)
//   logit = gelu(z4) . w5 + b5
//   prob  = sigmoid(logit) if slot i and slot j are live, else 0
//
// with LayerNorm as flax's (f32 statistics, E[y^2] - E[y]^2 clamped at 0,
// eps 1e-6) and gelu its tanh form.  Products take bf16 operands and sum
// in f32; the biases, w_d and w5 are the bf16-rounded parameters, as the
// configuration's dense layers use them.  What the eager path rounds to
// bf16 between steps (the pair sum, z3, z4, the logit) stays f32 here.
//
// What bounds it on this card: at (B, V, F) = (512, 40, 512) the two
// products are 131 GFLOP (0.13 ms at the bf16 peak) and the bytes it must
// move, u_i and u_j once plus the outputs, 45 MB (14 us); the eager chain
// moved ~20 (B, E, F) tensors through device memory.  So nothing of shape
// (B, E, .) leaves the SM:
//   - Persistent blocks, one an SM, walk tiles of 128 pair rows in order,
//     so the blocks in flight share a few clouds' u rows in L2.
//   - Prologue: each warp builds 16 rows of the A tile (128 x F bf16 in
//     shared memory): the two u rows gathered with 16-byte loads (the next
//     two rows' loads in flight while a row is reduced), the pair sum,
//     LayerNorm_2 by a warp butterfly, GELU, bf16.
//   - Two products with mma.sync m16n8k16 (bf16, f32 accumulate) on eight
//     warps, 2 along the rows x 4 along the columns.  W3 and W4 stream
//     from L2 through one ring of 64-deep chunks (cp.async, 2 stages: one
//     chunk in flight under the product of the other; a barrier every
//     four k-steps, which took 10% off the kernel against 32-deep chunks
//     in 3 stages) as one periodic sequence across tiles, so the next
//     tile's first W3 chunk arrives during this tile's second product.
//   - Epilogue 1: b3, LayerNorm_3 (a quad's shuffle, then the four column
//     warps' partials through shared memory), GELU; bf16 H (128 x F/2)
//     written over the spent A tile.  Epilogue 2: b4, GELU, the dot with
//     w5 reduced the same way, b5, sigmoid, the slot mask; each row writes
//     its logit, probability and pair mask.
// mma.sync and not wgmma, one phase after another: a first design that is
// simple to hold right.  Its time splits about evenly between the products
// and the elementwise phases (PERF.md), so a wgmma main loop beside a
// warpgroup that builds the next A tile is where more would come from.
//
// Host side: plain C interface (ops/pair_mlp.py loads it with ctypes);
// F is 256 or 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // pair rows a tile
constexpr int THREADS = 256;     // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int KC = 64;           // depth of a weight chunk in the ring
constexpr int STAGES = 2;        // chunks in the ring
constexpr int PAD = 8;           // bf16 elements of padding a shared row
constexpr int SMEM_LIMIT = 232448;
constexpr float LN_EPS = 1e-6f;

struct Params {
    const bf16* ui;              // (B, V, F)
    const bf16* uj;              // (B, V, F)
    const bf16* x;               // (B, V, C)
    const unsigned char* slot;   // (B, V), 0 or 1
    const bf16* w3;              // (F/2, F)
    const bf16* w4;              // (F/4, F/2)
    const float* vec;            // see Layout: wd b2 g2 be2 b3 g3 be3 b4 w5 b5
    float* logits;               // (B, E)
    float* probs;                // (B, E)
    unsigned char* mask;         // (B, E)
    int B, V, C, E;
    long long M;                 // B * E
    int tiles;
};

// A row of the tile: the u rows of its pair (-1 past the last row), the
// distance of the pair's slots and whether both are live.
struct RowInfo {
    int ri, rj;
    float dist;
    int live;
};

template <int F>
struct Layout {
    static constexpr int F2 = F / 2, F4 = F / 4;
    static constexpr int LDA = F + PAD;          // A and H rows
    static constexpr int LDW = KC + PAD;         // ring rows
    static constexpr int CH1 = F / KC, CH2 = F2 / KC, CHUNKS = CH1 + CH2;
    static constexpr int NB1 = F2 / 32;          // n8 blocks a warp, product 1
    static constexpr int NB2 = F4 / 32;          // and product 2
    static constexpr int NK = F / 256;           // 16-byte pieces a lane, a row
    // The f32 vector's parts (floats).
    static constexpr int WD = 0, B2 = F, G2 = 2 * F, BE2 = 3 * F;
    static constexpr int B3 = 4 * F, G3 = B3 + F2, BE3 = G3 + F2;
    static constexpr int B4 = BE3 + F2, W5 = B4 + F4, B5 = W5 + F4;
    static constexpr int NVEC = B5 + 1;
    // Shared memory (bytes).
    static constexpr int A_BYTES = BM * LDA * 2;
    static constexpr int STAGE_ELEMS = F2 * LDW;
    static constexpr int RING_OFF = A_BYTES;
    static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
    static constexpr int VEC_OFF = RING_OFF + RING_BYTES;
    static constexpr int VEC_BYTES = (NVEC + 3) / 4 * 16;
    static constexpr int ROWS_OFF = VEC_OFF + VEC_BYTES;
    static constexpr int PART_OFF = ROWS_OFF + BM * (int)sizeof(RowInfo);
    static constexpr int TOTAL = PART_OFF + 4 * BM * 8;
    static_assert(F % 256 == 0, "F is a multiple of 256");
    static_assert(NB1 % 2 == 0 && NB2 % 2 == 0, "n8 blocks come in pairs");
    static_assert(TOTAL <= SMEM_LIMIT, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
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

// flax's nn.gelu (tanh form): 0.5 x (1 + tanh u) = x / (1 + exp(-2u)).
__device__ __forceinline__ float gelu(float x) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return __fdividef(x, 1.0f + __expf(-2.0f * u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float2 t = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u[k]));
        f[2 * k] = t.x;
        f[2 * k + 1] = t.y;
    }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ RowInfo row_info(const Params& p, long long r) {
    RowInfo o;
    o.ri = -1;
    o.rj = -1;
    o.dist = 0.0f;
    o.live = 0;
    if (r >= p.M) return o;
    const int b = (int)(r / p.E);
    int e = (int)(r - (long long)b * p.E);
    int i = 0;
    while (e >= p.V - 1 - i) {
        e -= p.V - 1 - i;
        ++i;
    }
    const int bi = b * p.V + i, bj = b * p.V + i + 1 + e;
    float s = 0.0f;
    for (int c = 0; c < p.C; ++c) {
        const float d = __bfloat162float(p.x[(size_t)bi * p.C + c]) -
                        __bfloat162float(p.x[(size_t)bj * p.C + c]);
        s += d * d;
    }
    o.ri = bi;
    o.rj = bj;
    o.dist = sqrtf(s + 1e-12f);
    o.live = (p.slot[bi] != 0) && (p.slot[bj] != 0);
    return o;
}

// Chunk n of the periodic weight stream (W3's CH1 chunks, then W4's CH2)
// into its ring stage: each thread copies 16-byte pieces.
template <int F>
__device__ __forceinline__ void load_chunk(const Params& p, bf16* ring, int n,
                                           int tid) {
    using L = Layout<F>;
    const int which = n % L::CHUNKS;
    bf16* dst = ring + (n % STAGES) * L::STAGE_ELEMS;
    const bf16* src;
    int ld, rows, k0;
    if (which < L::CH1) {
        src = p.w3;
        ld = F;
        rows = L::F2;
        k0 = which * KC;
    } else {
        src = p.w4;
        ld = L::F2;
        rows = L::F4;
        k0 = (which - L::CH1) * KC;
    }
    constexpr int PIECES = KC / 8;
    for (int q = tid; q < rows * PIECES; q += THREADS) {
        const int r = q / PIECES, s = q % PIECES;
        cp_async16(dst + r * L::LDW + s * 8, src + (size_t)r * ld + k0 + s * 8);
    }
}

// Wait for chunk c, then queue chunk c + STAGES - 1 into the stage that
// chunk c - 1 held (every warp is past it after the barrier).
template <int F>
__device__ __forceinline__ void ring_step(const Params& p, bf16* ring, int c,
                                          int total, int tid) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int n = c + STAGES - 1;
    if (n < total) load_chunk<F>(p, ring, n, tid);
    cp_commit();
}

// One chunk's product: acc (this warp's 64 rows x 8 NB columns) += A rows
// [k0, k0 + KC) against the chunk's NB * 4 * 8 weight rows.
template <int NB>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][NB][4],
                                          const bf16* A, int lda, int k0,
                                          const bf16* W, int warp, int lane) {
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
            ldsm_x4(a[mt], A + (wm * 64 + mt * 16 + (lane & 15)) * lda + k0 +
                               ks * 16 + (lane >> 4) * 8);
        uint32_t b[NB][2];
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
            uint32_t r[4];
            ldsm_x4(r, W + (wn * NB * 8 + np * 16 + (lane & 7) +
                            ((lane >> 4) << 3)) * (KC + PAD) +
                           ks * 16 + ((lane >> 3) & 1) * 8);
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
                mma_bf16(acc[mt][nb], a[mt], b[nb][0], b[nb][1]);
    }
}

// Two rows' u pieces: [h][k] of u_i, [h][NK + k] of u_j (zeros past M).
template <int F>
__device__ __forceinline__ void load_rows(const Params& p,
                                          const RowInfo* rows, int r,
                                          int lane,
                                          uint4 (&buf)[2][2 * (F / 256)]) {
    constexpr int NK = F / 256;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const RowInfo ri = rows[r + h];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
            const int c0 = (k * 32 + lane) * 8;
            if (ri.ri >= 0) {
                buf[h][k] = __ldg(reinterpret_cast<const uint4*>(
                    p.ui + (size_t)ri.ri * F + c0));
                buf[h][NK + k] = __ldg(reinterpret_cast<const uint4*>(
                    p.uj + (size_t)ri.rj * F + c0));
            } else {
                buf[h][k] = make_uint4(0, 0, 0, 0);
                buf[h][NK + k] = make_uint4(0, 0, 0, 0);
            }
        }
    }
}

// The A tile: each warp builds rows [16 warp, 16 warp + 16).
template <int F>
__device__ __forceinline__ void build_a(const Params& p, bf16* A,
                                        const float* vec,
                                        const RowInfo* rows, int warp,
                                        int lane) {
    using L = Layout<F>;
    constexpr int NK = L::NK;
    constexpr int ROWS = BM / WARPS;
    // This lane's columns of w_d, b_2 and LayerNorm_2, for every row.
    float wd[NK][8], b2[NK][8], g2[NK][8], be2[NK][8];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
        const int c0 = (k * 32 + lane) * 8;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            wd[k][q] = vec[L::WD + c0 + q];
            b2[k][q] = vec[L::B2 + c0 + q];
            g2[k][q] = vec[L::G2 + c0 + q];
            be2[k][q] = vec[L::BE2 + c0 + q];
        }
    }
    const int r0 = warp * ROWS;
    uint4 cur[2][2 * NK], nxt[2][2 * NK];
    load_rows<F>(p, rows, r0, lane, cur);
#pragma unroll 1
    for (int rr = 0; rr < ROWS; rr += 2) {
        if (rr + 2 < ROWS) load_rows<F>(p, rows, r0 + rr + 2, lane, nxt);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = r0 + rr + h;
            const float dist = rows[row].dist;
            float y[NK][8];
            float s = 0.0f, sq = 0.0f;
#pragma unroll
            for (int k = 0; k < NK; ++k) {
                float a[8], b[8];
                unpack8(cur[h][k], a);
                unpack8(cur[h][NK + k], b);
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    const float v = ((a[q] + b[q]) + dist * wd[k][q]) +
                                    b2[k][q];
                    y[k][q] = v;
                    s += v;
                    sq += v * v;
                }
            }
            s = warp_sum(s);
            sq = warp_sum(sq);
            const float mean = s * (1.0f / F);
            const float var = fmaxf(sq * (1.0f / F) - mean * mean, 0.0f);
            const float rs = rsqrtf(var + LN_EPS);
#pragma unroll
            for (int k = 0; k < NK; ++k) {
                float o[8];
#pragma unroll
                for (int q = 0; q < 8; ++q)
                    o[q] = gelu((y[k][q] - mean) * (rs * g2[k][q]) +
                                be2[k][q]);
                const uint4 w = make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]),
                                           pack2(o[4], o[5]),
                                           pack2(o[6], o[7]));
                *reinterpret_cast<uint4*>(A + row * L::LDA +
                                          (k * 32 + lane) * 8) = w;
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int k = 0; k < 2 * NK; ++k) cur[h][k] = nxt[h][k];
    }
}

template <int F>
__global__ void __launch_bounds__(THREADS, 1) pair_mlp_kernel(const Params p) {
    using L = Layout<F>;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* A = reinterpret_cast<bf16*>(smem);
    bf16* ring = reinterpret_cast<bf16*>(smem + L::RING_OFF);
    float* vec = reinterpret_cast<float*>(smem + L::VEC_OFF);
    RowInfo* rows = reinterpret_cast<RowInfo*>(smem + L::ROWS_OFF);
    float2* part = reinterpret_cast<float2*>(smem + L::PART_OFF);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
    for (int k = tid; k < L::NVEC; k += THREADS) vec[k] = p.vec[k];

    const int my_tiles = (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                         (int)gridDim.x;
    const int total = my_tiles * L::CHUNKS;
#pragma unroll
    for (int n = 0; n < STAGES - 1; ++n) {
        if (n < total) load_chunk<F>(p, ring, n, tid);
        cp_commit();
    }
    int c = 0;   // the next chunk of the stream

    for (int t = 0; t < my_tiles; ++t) {
        const long long tile = (long long)blockIdx.x + (long long)t * gridDim.x;
        if (tid < BM) rows[tid] = row_info(p, tile * BM + tid);
        __syncthreads();
        build_a<F>(p, A, vec, rows, warp, lane);

        // z3 = h1 W3^T (the ring's barriers order the A tile's writes).
        float acc1[4][L::NB1][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nb = 0; nb < L::NB1; ++nb)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc1[mt][nb][q] = 0.0f;
#pragma unroll 1
        for (int k = 0; k < L::CH1; ++k, ++c) {
            ring_step<F>(p, ring, c, total, tid);
            mma_chunk<L::NB1>(acc1, A, L::LDA, k * KC,
                              ring + (c % STAGES) * L::STAGE_ELEMS, warp,
                              lane);
        }

        // Epilogue 1: + b3, LayerNorm_3 over the F/2 columns, GELU -> H.
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float s = 0.0f, sq = 0.0f;
#pragma unroll
                for (int nb = 0; nb < L::NB1; ++nb) {
                    const int col = wn * L::NB1 * 8 + nb * 8 + 2 * tq;
                    const float v0 = acc1[mt][nb][2 * h] + vec[L::B3 + col];
                    const float v1 =
                        acc1[mt][nb][2 * h + 1] + vec[L::B3 + col + 1];
                    acc1[mt][nb][2 * h] = v0;
                    acc1[mt][nb][2 * h + 1] = v1;
                    s += v0 + v1;
                    sq += v0 * v0 + v1 * v1;
                }
                s = quad_sum(s);
                sq = quad_sum(sq);
                if (tq == 0)
                    part[wn * BM + wm * 64 + mt * 16 + h * 8 + g] =
                        make_float2(s, sq);
            }
        }
        __syncthreads();   // every warp is past its product: A is spent
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = wm * 64 + mt * 16 + h * 8 + g;
                const float2 p0 = part[row], p1 = part[BM + row],
                             p2 = part[2 * BM + row], p3 = part[3 * BM + row];
                const float s = (p0.x + p1.x) + (p2.x + p3.x);
                const float sq = (p0.y + p1.y) + (p2.y + p3.y);
                const float mean = s * (1.0f / L::F2);
                const float var =
                    fmaxf(sq * (1.0f / L::F2) - mean * mean, 0.0f);
                const float rs = rsqrtf(var + LN_EPS);
#pragma unroll
                for (int nb = 0; nb < L::NB1; ++nb) {
                    const int col = wn * L::NB1 * 8 + nb * 8 + 2 * tq;
                    const float o0 = gelu(
                        (acc1[mt][nb][2 * h] - mean) * (rs * vec[L::G3 + col]) +
                        vec[L::BE3 + col]);
                    const float o1 =
                        gelu((acc1[mt][nb][2 * h + 1] - mean) *
                                 (rs * vec[L::G3 + col + 1]) +
                             vec[L::BE3 + col + 1]);
                    *reinterpret_cast<uint32_t*>(A + row * L::LDA + col) =
                        pack2(o0, o1);
                }
            }
        }

        // z4 = h3 W4^T (the ring's first barrier orders H's writes).
        float acc2[4][L::NB2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nb = 0; nb < L::NB2; ++nb)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc2[mt][nb][q] = 0.0f;
#pragma unroll 1
        for (int k = 0; k < L::CH2; ++k, ++c) {
            ring_step<F>(p, ring, c, total, tid);
            mma_chunk<L::NB2>(acc2, A, L::LDA, k * KC,
                              ring + (c % STAGES) * L::STAGE_ELEMS, warp,
                              lane);
        }

        // Epilogue 2: + b4, GELU, . w5 (each row's four column warps'
        // partials in order), + b5, sigmoid, the mask.
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float d = 0.0f;
#pragma unroll
                for (int nb = 0; nb < L::NB2; ++nb) {
                    const int col = wn * L::NB2 * 8 + nb * 8 + 2 * tq;
                    d += gelu(acc2[mt][nb][2 * h] + vec[L::B4 + col]) *
                             vec[L::W5 + col] +
                         gelu(acc2[mt][nb][2 * h + 1] + vec[L::B4 + col + 1]) *
                             vec[L::W5 + col + 1];
                }
                d = quad_sum(d);
                if (tq == 0)
                    part[wn * BM + wm * 64 + mt * 16 + h * 8 + g] =
                        make_float2(d, 0.0f);
            }
        }
        __syncthreads();
        if (tid < BM) {
            const RowInfo ri = rows[tid];
            if (ri.ri >= 0) {
                const float logit =
                    ((part[tid].x + part[BM + tid].x) +
                     (part[2 * BM + tid].x + part[3 * BM + tid].x)) +
                    vec[L::B5];
                const long long r = tile * BM + tid;
                p.logits[r] = logit;
                p.probs[r] = ri.live ? 1.0f / (1.0f + expf(-logit)) : 0.0f;
                p.mask[r] = (unsigned char)ri.live;
            }
        }
        __syncthreads();   // rows, part and A are the next tile's
    }
    cp_wait<0>();
}

bool aligned16(const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

template <int F>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
    auto kernel = pair_mlp_kernel<F>;
    static int ready = -1;
    if (ready != 0 &&
        (ready = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             Layout<F>::TOTAL)) != 0)
        return ready;
    if (smem != Layout<F>::TOTAL) return (int)cudaErrorInvalidValue;
    kernel<<<grid, THREADS, smem, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    return (int)e;
}

}  // namespace

extern "C" {

// The constants ops/pair_mlp.py plans with: 0 rows a tile, 1 threads a
// block, 2 the ring chunks' depth, 3 the ring's stages, 4 the padding of
// a shared row, 5 the shared-memory limit.
int pair_mlp_const(int which) {
    switch (which) {
        case 0: return BM;
        case 1: return THREADS;
        case 2: return KC;
        case 3: return STAGES;
        case 4: return PAD;
        case 5: return SMEM_LIMIT;
        default: return -1;
    }
}

// Dynamic shared memory of a block at width F (-1: a width not built).
int pair_mlp_smem(int F) {
    switch (F) {
        case 256: return Layout<256>::TOTAL;
        case 512: return Layout<512>::TOTAL;
        default: return -1;
    }
}

// The pair MLP over every pair of every cloud: UI, UJ (B, V, F) bf16 and X
// (B, V, C) bf16 contiguous, SLOT (B, V) bytes 0 / 1, W3 (F/2, F) and W4
// (F/4, F/2) bf16 contiguous, VEC the f32 vector of ops/pair_mlp.py's
// pack_weights; LOGITS, PROBS (B, E) f32 and MASK (B, E) bytes written.
// grid persistent blocks (at most the tiles), smem pair_mlp_smem(F).
int pair_mlp(const void* UI, const void* UJ, const void* X, const void* SLOT,
             const void* W3, const void* W4, const float* VEC, float* LOGITS,
             float* PROBS, void* MASK, int B, int V, int C, int F, int grid,
             int smem, cudaStream_t stream) {
    if (B < 1 || V < 2 || C < 1 || grid < 1) return (int)cudaErrorInvalidValue;
    if (!aligned16(UI) || !aligned16(UJ) || !aligned16(W3) || !aligned16(W4))
        return (int)cudaErrorInvalidValue;
    Params p;
    p.ui = static_cast<const bf16*>(UI);
    p.uj = static_cast<const bf16*>(UJ);
    p.x = static_cast<const bf16*>(X);
    p.slot = static_cast<const unsigned char*>(SLOT);
    p.w3 = static_cast<const bf16*>(W3);
    p.w4 = static_cast<const bf16*>(W4);
    p.vec = VEC;
    p.logits = LOGITS;
    p.probs = PROBS;
    p.mask = static_cast<unsigned char*>(MASK);
    p.B = B;
    p.V = V;
    p.C = C;
    p.E = V * (V - 1) / 2;
    p.M = (long long)B * p.E;
    const long long tiles = (p.M + BM - 1) / BM;
    if (tiles > 0x7fffffffLL || grid > tiles) return (int)cudaErrorInvalidValue;
    p.tiles = (int)tiles;
    switch (F) {
        case 256: return launch<256>(p, grid, smem, stream);
        case 512: return launch<512>(p, grid, smem, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
