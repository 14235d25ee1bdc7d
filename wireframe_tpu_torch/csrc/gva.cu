// Point Transformer V2's grouped vector attention at inference, one launch
// a GVA, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no PTv2.  It was added
// because the eager form (ops/gva.py's gva_plain) spent ~105 of a ~163 ms
// batch-128 call in some 89 PyTorch ops a GVA, ~21 float32 passes over
// each level's capacity rows x k x C.  For row i, its k neighbours j
// (index -1: missing) and C channels in G = C / 8 groups:
//
//   q_i  = ReLU(BN_q(q_i + b_q))     k_j = ReLU(BN_k(k_j + b_k))
//   v_j  = v_j + b_v                 (0 for a missing j, key and value)
//   p_ij = xyz_j - xyz_i             (0 for a missing j)
//   peb  = pe2(ReLU(BN_pe(pe1(p_ij))))
//   r_ij = (k_j - q_i) + peb         val_ij = v_j + peb
//   w_ij = we2(ReLU(BN_we(we1(r_ij)))), softmax over j, x (j not missing)
//   out_i[c] = sum_j w_ij[c / 8] val_ij[c]
//
// q, k and v come in as the products x W^T in bf16 (three dense GEMMs of
// the caller); every parameter comes in float32 as the module stores it.
// The numerics are the plain version's: each product takes bf16 operands
// and sums in f32, its output and its bias are rounded to bf16 and added
// with one more rounding (a bf16 Linear); BatchNorm is folded in the block
// from the running statistics as `BatchNorm.forward` folds it (rsqrt(var +
// eps) weight, bias - mean scale, then x scale + shift), ReLU, the
// relation and value sums, the softmax and the weighted sum in f32, that
// sum in neighbour order.  No float atomics.
//
// What bounds it on this card: at the benchmark's batch-128 call the 17
// GVAs' products on the neighbour slots are ~0.5 TFLOP over the capacity
// rows (~0.5 ms at the bf16 peak) and the bytes they must move (q, k, v
// in bf16, xyz, the indices, the weights once, the output in f32) ~1.3 GB
// (~0.4 ms).  The eager form moved ~40 GB through device memory at level 0
// alone.  So nothing of shape rows x k x C leaves the SM:
//   - A block owns 16 x WARPS pair rows (16 / k query rows a warp, each
//     row's k neighbours side by side), and each warp owns 16 of them
//     through every phase: rows are independent until the softmax, whose
//     k rows lie inside one warp.
//   - A warp whose rows have no neighbour (the capacity's dummy rows)
//     writes 0, which is what the plain version gives, and runs no
//     product; a block of such warps stops after its stores.  Each block
//     adds its real neighbour slots and those rows to two int64 counters
//     (and block 0 the call's M k slots to a third), one integer
//     atomicAdd each.
//   - The gathers: a live warp starts cp.async copies of its neighbours'
//     k rows and its query rows' q into shared memory (GA) before the
//     block's set-up, and of the neighbours' v rows once r_ij is formed,
//     so that both land under the products.
//   - Phase A: the warp's 16 positions, pe1 (K = 3) in FFMA on bf16
//     operands, bias, BN, ReLU, bf16: the A tile H (16 x C) in shared
//     memory.
//   - Phase B: pe2 (C x C) and then we1 (C -> G) on mma.sync m16n8k16 from
//     one ring of weight chunks of whole rows (output columns): pe2's,
//     then we1's padded to a multiple of 16 groups with zeros, 16 or 32
//     rows a chunk by width (`GVA_WIDTHS`).  The block stages each chunk
//     from L2 in f32, rounds it to bf16 (round to nearest even, as
//     `.to(bfloat16)`) as it stores it, and loads the next chunk into
//     registers while the warps multiply this one; one barrier a chunk.
//     pe2's epilogue writes peb as bf16 (exact: the plain version rounds
//     it so) to PEB (16 x C); after the last pe2 chunk the warp forms r_ij
//     over H (k_j and q_i from GA, with bias, BN and ReLU applied on
//     load).  Each product's depth is split over
//     up to four accumulator sets, summed in order after it, so that no
//     chain of dependent mma.sync runs longer than eight steps.
//   - Phase C, in registers: we1's bias, BN, ReLU and bf16 rounding turn
//     its accumulators into the A fragments of we2 (G x G, staged once a
//     block); we2's bias; the softmax over each query row's k slots by
//     warp shuffles; the weights to shared memory over H.
//   - Phase D: out_i = sum_j w_ij (v_j + peb_ij), v_j from GA, written
//     once in f32.
// mma.sync and not wgmma: the products are small (16-row warp tiles, C
// from 48 to 512), and the work around them (positions, BN, the relation,
// the softmax, the weighted sum) is of the same size.  What holds it back
// (PERF.md): at C = 48 the f32 elementwise work with its bf16 roundings
// (~2,500 instructions a pair row), at C >= 384 one block an SM, its
// weights streamed from L2 in f32 every 64 pair rows.
//
// Host side: plain C interface (ops/gva.py loads it with ctypes); C in
// {48, 96, 192, 384, 512}, G = C / 8, k in {8, 16}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;          // bf16 elements of padding a shared row
constexpr int SMEM_LIMIT = 232448;
constexpr float BN_EPS = 1e-5f;
constexpr unsigned FULL = 0xffffffffu;

// ops/gva.py's TENSORS, in order.
enum Tensor {
    T_Q, T_K, T_V, T_NBR, T_XYZ,
    T_QB, T_KB, T_VB,
    T_QBN, T_KBN = T_QBN + 4,
    T_PE1W = T_KBN + 4, T_PE1B, T_PEBN,
    T_PE2W = T_PEBN + 4, T_PE2B, T_WE1W, T_WE1B, T_WEBN,
    T_WE2W = T_WEBN + 4, T_WE2B,
    T_OUT, T_COUNTERS, N_TENSORS
};
// A BatchNorm's four tensors: weight, bias, running_mean, running_var.

struct Params {
    const void* t[N_TENSORS];
    int M, ld;
};

// A block's warps and the weight rows (output columns) of a ring chunk,
// pe2's (NCP) and we1's (NCW), at width C: chunks whose f32 staging keeps
// a thread's registers few enough for the blocks an SM holds, and at C =
// 512 three warps, so that the block's shared memory fits.
#define GVA_WIDTHS(X) X(48, 8, 16, 16) X(96, 8, 32, 16) X(192, 8, 32, 32) \
    X(384, 4, 16, 16) X(512, 3, 16, 16)

template <int C>
struct Tiles;
#define GVA_TILES(c, w, ncp, ncw)                       \
    template <>                                         \
    struct Tiles<c> {                                   \
        static constexpr int WARPS = w, NCP = ncp, NCW = ncw; \
    };
GVA_WIDTHS(GVA_TILES)
#undef GVA_TILES

template <int C>
struct Layout {
    static constexpr int G = C / 8, GP = (G + 15) / 16 * 16;
    static constexpr int WARPS = Tiles<C>::WARPS, THREADS = 32 * WARPS;
    static constexpr int NCP = Tiles<C>::NCP, NCW = Tiles<C>::NCW;
    static constexpr int LDC = C + PAD, LDG = GP + PAD;
    static constexpr int NW2 = C / NCP, CHUNKS = NW2 + GP / NCW;
    static constexpr int ROWS = NCP > NCW ? NCP : NCW;   // a stage's rows
    // Independent accumulators a product splits its depth over, so that
    // no chain of dependent mma.sync runs longer than 8 steps.
    static constexpr int KP = C / 16 >= 24 ? 4 : C / 16 >= 6 ? 2 : 1;
    // The f32 parameters in shared memory (floats): pe1's weight (C x 3)
    // and bias, pe_bn's scale and shift, pe2's bias, q's bias and q_bn's
    // scale and shift, k's the same, v's bias; then over GP groups (0 past
    // G) we1's bias, we_bn's scale and shift, we2's bias.  Biases as their
    // bf16 roundings.
    static constexpr int PE1W = 0, B1 = 3 * C, PES = 4 * C, PET = 5 * C,
                         B2 = 6 * C, QB = 7 * C, QS = 8 * C, QT = 9 * C,
                         KB = 10 * C, KS = 11 * C, KT = 12 * C, VB = 13 * C,
                         BE1 = 14 * C, WES = BE1 + GP, WET = WES + GP,
                         BE2 = WET + GP, NPAR = BE2 + GP;
    // Shared memory (bytes): parameters, we2 (GP x LDG bf16), the ring (2
    // stages of ROWS x LDC bf16), then each warp's H and PEB (16 x LDC bf16
    // each), the gathered rows GA (18 x LDC bf16: the 16 neighbours' k,
    // then their v; the query rows' q after them), 16 neighbour rows and
    // the query rows (int, 32 places) and 16 positions (3 f32).
    static constexpr int WE2_OFF = NPAR * 4;
    static constexpr int RING_OFF = WE2_OFF + GP * LDG * 2;
    static constexpr int STAGE = ROWS * LDC;
    static constexpr int WARP_OFF = RING_OFF + 2 * STAGE * 2;
    static constexpr int H_BYTES = 16 * LDC * 2, GA_BYTES = 18 * LDC * 2;
    static constexpr int WARP_BYTES =
        2 * H_BYTES + GA_BYTES + 32 * 4 + 16 * 3 * 4;
    static constexpr int TOTAL = WARP_OFF + WARPS * WARP_BYTES;
    // float4 pieces a thread stages of the larger chunk.
    static constexpr int PER_THREAD = (ROWS * C / 4 + THREADS - 1) / THREADS;
    static_assert(C % NCP == 0 && GP % NCW == 0 && NCP % 16 == 0 &&
                  NCW % 16 == 0 && (C / 16) % KP == 0, "chunks");
    static_assert(WE2_OFF % 16 == 0 && WARP_BYTES % 16 == 0, "alignment");
    static_assert(16 * GP * 4 <= H_BYTES, "the weights fit over H");
    static_assert(TOTAL <= SMEM_LIMIT, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ float bfr(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&u);
    return __bfloat1622float2(t);
}

// A bf16 Linear's output: the product rounded to bf16, plus the bias (its
// bf16 rounding), rounded again.
__device__ __forceinline__ float lin_out(float prod, float bias_bf) {
    return bfr(__fadd_rn(bfr(prod), bias_bf));
}

// BatchNorm's fold from its tensors (BatchNorm.forward's two lines).
__device__ __forceinline__ void bn_fold(const void* const* bn, int c,
                                        float& scale, float& shift) {
    const float w = __ldg(static_cast<const float*>(bn[0]) + c);
    const float b = __ldg(static_cast<const float*>(bn[1]) + c);
    const float mean = __ldg(static_cast<const float*>(bn[2]) + c);
    const float var = __ldg(static_cast<const float*>(bn[3]) + c);
    scale = __fmul_rn(rsqrtf(__fadd_rn(var, BN_EPS)), w);
    shift = __fsub_rn(b, __fmul_rn(mean, scale));
}

__device__ __forceinline__ float bn_relu(float x, float scale, float shift) {
    return fmaxf(fmaf(x, scale, shift), 0.0f);
}

// Chunk `s` of the weight rows into registers: pe2's rows NCP s.. for s <
// NW2, else we1's rows NCW (s - NW2).., zero past G.
template <int C>
using Staged = float4[Layout<C>::PER_THREAD];

template <int C>
__device__ __forceinline__ void chunk_load(const Params& p, int s, int tid,
                                           Staged<C>& pre) {
    using L = Layout<C>;
    const bool w2 = s < L::NW2;
    const float* src = static_cast<const float*>(p.t[w2 ? T_PE2W : T_WE1W]);
    const int row0 = w2 ? s * L::NCP : (s - L::NW2) * L::NCW;
    const int pieces = (w2 ? L::NCP : L::NCW) * C / 4;
#pragma unroll
    for (int i = 0; i < L::PER_THREAD; ++i) {
        const int q = tid + i * L::THREADS;
        const int r = q / (C / 4), c4 = q % (C / 4);
        pre[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < pieces && (w2 || row0 + r < L::G))
            pre[i] = __ldg(reinterpret_cast<const float4*>(
                src + (size_t)(row0 + r) * C) + c4);
    }
}

// The staged chunk `s` to a stage of the ring, rounded to bf16.
template <int C>
__device__ __forceinline__ void chunk_store(bf16* stage, int s, int tid,
                                            const Staged<C>& pre) {
    using L = Layout<C>;
    const int pieces = (s < L::NW2 ? L::NCP : L::NCW) * C / 4;
#pragma unroll
    for (int i = 0; i < L::PER_THREAD; ++i) {
        const int q = tid + i * L::THREADS;
        if (q >= pieces) break;
        const int r = q / (C / 4), c4 = q % (C / 4);
        *reinterpret_cast<uint2*>(stage + r * L::LDC + 4 * c4) =
            make_uint2(pack2(pre[i].x, pre[i].y), pack2(pre[i].z, pre[i].w));
    }
}

// acc (16 x 8 NT: NT n8 tiles) = A (16 x C, shared, row stride LDC) times
// the stage's first 8 NT rows (each C deep).
template <int C, int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[NT][4], const bf16* A,
                                          const bf16* B, int lane) {
    using L = Layout<C>;
    float part[L::KP][NT][4];
#pragma unroll
    for (int k = 0; k < L::KP; ++k)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[k][t][e] = 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < C / 16; k0 += L::KP) {
#pragma unroll
        for (int k = 0; k < L::KP; ++k) {
            const int ks = k0 + k;
            uint32_t a[4];
            ldsm_x4(a, A + (lane & 15) * L::LDC + ks * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t b[4];
                ldsm_x4(b, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   L::LDC + ks * 16 + ((lane >> 3) & 1) * 8);
                mma_bf16(part[k][2 * np], a, b[0], b[1]);
                mma_bf16(part[k][2 * np + 1], a, b[2], b[3]);
            }
        }
    }
    // The parts summed in order.
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float v = part[0][t][e];
#pragma unroll
            for (int k = 1; k < L::KP; ++k) v = __fadd_rn(v, part[k][t][e]);
            acc[t][e] = v;
        }
}

// A 16-byte copy to shared memory, or 16 zero bytes with nothing read
// (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(read ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows `row[r]` (r < n; -1: zeros) of a (M, C) bf16 product into GA's rows
// first.. first + n - 1, 16 bytes a lane at a time; one commit group.
template <int C>
__device__ __forceinline__ void gather_rows(bf16* GA, int first, const int* row,
                                            int n, const void* t, int lane) {
    constexpr int SEG = C / 8;
    const bf16* src = static_cast<const bf16*>(t);
    for (int e = lane; e < n * SEG; e += 32) {
        const int r = e / SEG, j = e % SEG, x = row[r];
        cp_async16(GA + (first + r) * Layout<C>::LDC + 8 * j,
                   src + (size_t)(x < 0 ? 0 : x) * C + 8 * j, x >= 0);
    }
    cp_commit();
}

// Row r's channels c, c + 1 of a shared bf16 tile of row stride ldc, as
// raw bits.
__device__ __forceinline__ uint32_t smem_pair(const bf16* t, int ldc, int r,
                                              int c) {
    return *reinterpret_cast<const uint32_t*>(t + r * ldc + c);
}

// A pair of a product with its bias added as a bf16 Linear adds it.
__device__ __forceinline__ float2 with_bias(uint32_t u, const float* bias,
                                            int c) {
    const float2 v = unpack2(u);
    return make_float2(bfr(__fadd_rn(v.x, bias[c])),
                       bfr(__fadd_rn(v.y, bias[c + 1])));
}

template <int C, int K>
__global__ void __launch_bounds__(Layout<C>::THREADS)
    gva_kernel(const Params p) {
    using L = Layout<C>;
    constexpr int PER_WARP = 16 / K;            // query rows a warp
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int dead_rows, real_slots;
    float* par = reinterpret_cast<float*>(smem);
    bf16* we2 = reinterpret_cast<bf16*>(smem + L::WE2_OFF);
    bf16* ring = reinterpret_cast<bf16*>(smem + L::RING_OFF);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned char* mine = smem + L::WARP_OFF + warp * L::WARP_BYTES;
    bf16* H = reinterpret_cast<bf16*>(mine);
    bf16* PEB = reinterpret_cast<bf16*>(mine + L::H_BYTES);
    bf16* GA = reinterpret_cast<bf16*>(mine + 2 * L::H_BYTES);
    int* nb = reinterpret_cast<int*>(mine + 2 * L::H_BYTES + L::GA_BYTES);
    float* pos = reinterpret_cast<float*>(mine + 2 * L::H_BYTES + L::GA_BYTES +
                                          32 * 4);
    float* wts = reinterpret_cast<float*>(H);     // over H, in phase C

    const int M = p.M;
    const int i0 = (blockIdx.x * L::WARPS + warp) * PER_WARP;
    float* out = static_cast<float*>(const_cast<void*>(p.t[T_OUT]));

    // The warp's neighbour rows: pair row r is query row i0 + r / K, slot
    // r % K; -1 missing or past M.  Then the query rows (-1 past M).
    int mine_nb = -1;
    if (lane < 16) {
        const int i = i0 + lane / K;
        if (i < M) {
            const long long v = __ldg(static_cast<const long long*>(
                p.t[T_NBR]) + (long long)i * p.ld + lane % K);
            mine_nb = (v >= 0 && v < M) ? (int)v : -1;
        }
        nb[lane] = mine_nb;
    } else if (lane < 16 + PER_WARP) {
        nb[lane] = i0 + lane - 16 < M ? i0 + lane - 16 : -1;
    }
    const unsigned has = __ballot_sync(FULL, mine_nb >= 0);
    const bool live = has != 0;
    // A live warp's gathers start now, under the block's set-up and pe2:
    // the neighbours' k and the query rows' q into GA, the positions'
    // coordinates into registers.
    const float* xyz = static_cast<const float*>(p.t[T_XYZ]);
    float xj[3] = {0.f, 0.f, 0.f}, xi[3] = {0.f, 0.f, 0.f};
    if (live) {
        __syncwarp();
        gather_rows<C>(GA, 0, nb, 16, p.t[T_K], lane);
        gather_rows<C>(GA, 16, nb + 16, PER_WARP, p.t[T_Q], lane);
        if (lane < 16 && mine_nb >= 0) {
            const int i = i0 + lane / K;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                xj[d] = __ldg(xyz + 3 * mine_nb + d);
                xi[d] = __ldg(xyz + 3 * i + d);
            }
        }
    }
    if (tid == 0) dead_rows = real_slots = 0;
    __syncthreads();
    if (lane == 0 && live) atomicAdd(&real_slots, __popc(has));
    if (!live) {
        const int rows = max(0, min(PER_WARP, M - i0));
        for (int e = lane; e < rows * (C / 2); e += 32) {
            const int i = i0 + e / (C / 2), c = 2 * (e % (C / 2));
            *reinterpret_cast<float2*>(out + (size_t)i * C + c) =
                make_float2(0.0f, 0.0f);
        }
        if (lane == 0 && rows) atomicAdd(&dead_rows, rows);
    }
    const int any_live = __syncthreads_or(live);
    if (tid == 0 && p.t[T_COUNTERS]) {
        unsigned long long* counts = static_cast<unsigned long long*>(
            const_cast<void*>(p.t[T_COUNTERS]));
        if (real_slots) atomicAdd(counts, (unsigned long long)real_slots);
        if (blockIdx.x == 0) atomicAdd(counts + 1, (unsigned long long)M * K);
        if (dead_rows) atomicAdd(counts + 2, (unsigned long long)dead_rows);
    }
    if (!any_live) return;

    // The block's parameters, folded, and we2 in bf16; chunk 0.  Loops of
    // fixed trip counts, so each thread's loads are in flight together.
    float4 pre[L::PER_THREAD];
    chunk_load<C>(p, 0, tid, pre);
#pragma unroll
    for (int u = 0; u < (C + L::THREADS - 1) / L::THREADS; ++u) {
        const int c = tid + u * L::THREADS;
        if (c >= C) break;
        const float* w1 = static_cast<const float*>(p.t[T_PE1W]);
#pragma unroll
        for (int d = 0; d < 3; ++d)
            par[L::PE1W + 3 * c + d] = bfr(w1[3 * c + d]);
        par[L::B1 + c] = bfr(static_cast<const float*>(p.t[T_PE1B])[c]);
        bn_fold(p.t + T_PEBN, c, par[L::PES + c], par[L::PET + c]);
        par[L::B2 + c] = bfr(static_cast<const float*>(p.t[T_PE2B])[c]);
        par[L::QB + c] = bfr(static_cast<const float*>(p.t[T_QB])[c]);
        bn_fold(p.t + T_QBN, c, par[L::QS + c], par[L::QT + c]);
        par[L::KB + c] = bfr(static_cast<const float*>(p.t[T_KB])[c]);
        bn_fold(p.t + T_KBN, c, par[L::KS + c], par[L::KT + c]);
        par[L::VB + c] = bfr(static_cast<const float*>(p.t[T_VB])[c]);
    }
    if (tid < L::GP) {
        const int g = tid;
        float be1 = 0.f, s = 0.f, t = 0.f, be2 = 0.f;
        if (g < L::G) {
            be1 = bfr(static_cast<const float*>(p.t[T_WE1B])[g]);
            bn_fold(p.t + T_WEBN, g, s, t);
            be2 = bfr(static_cast<const float*>(p.t[T_WE2B])[g]);
        }
        par[L::BE1 + g] = be1;
        par[L::WES + g] = s;
        par[L::WET + g] = t;
        par[L::BE2 + g] = be2;
    }
    {
        constexpr int N = (L::GP * L::GP + L::THREADS - 1) / L::THREADS;
        const float* w = static_cast<const float*>(p.t[T_WE2W]);
        float v[N];
#pragma unroll
        for (int u = 0; u < N; ++u) {
            const int e = tid + u * L::THREADS, r = e / L::GP, c = e % L::GP;
            v[u] = (r < L::G && c < L::G) ? __ldg(w + r * L::G + c) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < N; ++u) {
            const int e = tid + u * L::THREADS;
            if (e < L::GP * L::GP)
                we2[e / L::GP * L::LDG + e % L::GP] = __float2bfloat16_rn(v[u]);
        }
    }
    chunk_store<C>(ring, 0, tid, pre);
    __syncthreads();

    // Phase A: positions (bf16), then H = bf16(ReLU(BN_pe(pe1(p)))).
    if (live) {
        if (lane < 16) {
#pragma unroll
            for (int d = 0; d < 3; ++d)
                pos[lane * 3 + d] =
                    mine_nb >= 0 ? bfr(__fsub_rn(xj[d], xi[d])) : 0.0f;
        }
        __syncwarp();
        for (int c = 2 * lane; c < C; c += 64) {
            float w[6], b1[2], sc[2], sh[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int d = 0; d < 3; ++d)
                    w[3 * e + d] = par[L::PE1W + 3 * (c + e) + d];
                b1[e] = par[L::B1 + c + e];
                sc[e] = par[L::PES + c + e];
                sh[e] = par[L::PET + c + e];
            }
#pragma unroll 4
            for (int r = 0; r < 16; ++r) {
                const float p0 = pos[3 * r], p1 = pos[3 * r + 1];
                const float p2 = pos[3 * r + 2];
                float h[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float s =
                        __fadd_rn(__fadd_rn(__fmul_rn(p0, w[3 * e]),
                                            __fmul_rn(p1, w[3 * e + 1])),
                                  __fmul_rn(p2, w[3 * e + 2]));
                    h[e] = bn_relu(lin_out(s, b1[e]), sc[e], sh[e]);
                }
                *reinterpret_cast<uint32_t*>(H + r * L::LDC + c) =
                    pack2(h[0], h[1]);
            }
        }
        __syncwarp();
    }

    // Phase B: pe2's chunks, then we1's, through the ring.  After chunk s
    // the next chunk goes to the other stage and the block meets.
    const int g8 = lane >> 2, tq = lane & 3;
    auto next = [&](int s) {
        if (s + 1 < L::CHUNKS)
            chunk_store<C>(ring + ((s + 1) & 1) * L::STAGE, s + 1, tid, pre);
        __syncthreads();
    };
#pragma unroll 1
    for (int s = 0; s < L::NW2; ++s) {
        chunk_load<C>(p, s + 1, tid, pre);
        if (live) {
            float acc[L::NCP / 8][4];
            mma_chunk<C, L::NCP / 8>(acc, H, ring + (s & 1) * L::STAGE, lane);
            // peb for columns NCP s .. NCP s + NCP - 1, bf16 in PEB.
#pragma unroll
            for (int t = 0; t < L::NCP / 8; ++t) {
                const int col = s * L::NCP + t * 8 + 2 * tq;
                const float b0 = par[L::B2 + col], b1 = par[L::B2 + col + 1];
                *reinterpret_cast<uint32_t*>(PEB + g8 * L::LDC + col) =
                    pack2(lin_out(acc[t][0], b0), lin_out(acc[t][1], b1));
                *reinterpret_cast<uint32_t*>(PEB + (g8 + 8) * L::LDC + col) =
                    pack2(lin_out(acc[t][2], b0), lin_out(acc[t][3], b1));
            }
        }
        next(s);
    }
    if (live) {
        // H = bf16((k_j - q_i) + peb) over the spent pe1 tile, k and q
        // from GA; then the neighbours' v gathered into GA.
        cp_wait_all();
        __syncwarp();
        for (int c = 2 * lane; c < C; c += 64) {
            uint32_t kr[16], qr[PER_WARP];
#pragma unroll
            for (int r = 0; r < 16; ++r) kr[r] = smem_pair(GA, L::LDC, r, c);
#pragma unroll
            for (int u = 0; u < PER_WARP; ++u)
                qr[u] = smem_pair(GA, L::LDC, 16 + u, c);
            const float qs0 = par[L::QS + c], qs1 = par[L::QS + c + 1];
            const float qt0 = par[L::QT + c], qt1 = par[L::QT + c + 1];
            const float ks0 = par[L::KS + c], ks1 = par[L::KS + c + 1];
            const float kt0 = par[L::KT + c], kt1 = par[L::KT + c + 1];
            float2 q[PER_WARP];
#pragma unroll
            for (int u = 0; u < PER_WARP; ++u) {
                q[u] = with_bias(qr[u], par + L::QB, c);
                q[u].x = i0 + u < M ? bn_relu(q[u].x, qs0, qt0) : 0.0f;
                q[u].y = i0 + u < M ? bn_relu(q[u].y, qs1, qt1) : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < 16; ++r) {
                float2 k = make_float2(0.f, 0.f);
                if (nb[r] >= 0) {
                    k = with_bias(kr[r], par + L::KB, c);
                    k.x = bn_relu(k.x, ks0, kt0);
                    k.y = bn_relu(k.y, ks1, kt1);
                }
                const float2 pe = unpack2(
                    *reinterpret_cast<const uint32_t*>(PEB + r * L::LDC + c));
                *reinterpret_cast<uint32_t*>(H + r * L::LDC + c) =
                    pack2(__fadd_rn(__fsub_rn(k.x, q[r / K].x), pe.x),
                          __fadd_rn(__fsub_rn(k.y, q[r / K].y), pe.y));
            }
        }
        __syncwarp();
        gather_rows<C>(GA, 0, nb, 16, p.t[T_V], lane);
    }
    float accw[L::GP / 8][4];
#pragma unroll
    for (int u = 0; u < L::GP / L::NCW; ++u) {
        const int s = L::NW2 + u;
        if (s + 1 < L::CHUNKS) chunk_load<C>(p, s + 1, tid, pre);
        if (live) {
            float acc[L::NCW / 8][4];
            mma_chunk<C, L::NCW / 8>(acc, H, ring + (s & 1) * L::STAGE, lane);
#pragma unroll
            for (int t = 0; t < L::NCW / 8; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    accw[u * L::NCW / 8 + t][e] = acc[t][e];
        }
        next(s);
    }
    if (!live) return;

    // Phase C: we1's epilogue as we2's A fragments, we2, the softmax.
    uint32_t aw[L::GP / 16][4];
#pragma unroll
    for (int u = 0; u < L::GP / 16; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col = u * 16 + h * 8 + 2 * tq;
            float e[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int cc = col + (x & 1);
                e[x] = bfr(bn_relu(
                    lin_out(accw[2 * u + h][x], par[L::BE1 + cc]),
                    par[L::WES + cc], par[L::WET + cc]));
            }
            aw[u][2 * h] = pack2(e[0], e[1]);
            aw[u][2 * h + 1] = pack2(e[2], e[3]);
        }
    float lg[L::GP / 8][4];
#pragma unroll
    for (int t = 0; t < L::GP / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) lg[t][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < L::GP / 16; ++ks)
#pragma unroll
        for (int np = 0; np < L::GP / 16; ++np) {
            uint32_t b[4];
            const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldsm_x4(b, we2 + row * L::LDG + ks * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(lg[2 * np], aw[ks], b[0], b[1]);
            mma_bf16(lg[2 * np + 1], aw[ks], b[2], b[3]);
        }
    const bool has_lo = nb[g8] >= 0, has_hi = nb[g8 + 8] >= 0;
    __syncwarp();   // H's last reads (we1) are done: the weights go over it
#pragma unroll
    for (int t = 0; t < L::GP / 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = t * 8 + 2 * tq + e;
            // Rows g8 and g8 + 8.
            const float x0 = lin_out(lg[t][e], par[L::BE2 + col]);
            const float x1 = lin_out(lg[t][2 + e], par[L::BE2 + col]);
            // k = 16: the 16 rows are one query row's slots; k = 8: rows
            // 0-7 and 8-15 are two query rows.
            float m0 = x0, m1 = x1;
            if (K == 16) m0 = m1 = fmaxf(x0, x1);
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
                m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, o));
                m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, o));
            }
            const float e0 = expf(__fsub_rn(x0, m0));
            const float e1 = expf(__fsub_rn(x1, m1));
            float s0 = e0, s1 = e1;
            if (K == 16) s0 = s1 = __fadd_rn(e0, e1);
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
                s0 = __fadd_rn(s0, __shfl_xor_sync(FULL, s0, o));
                s1 = __fadd_rn(s1, __shfl_xor_sync(FULL, s1, o));
            }
            wts[g8 * L::GP + col] = has_lo ? __fdiv_rn(e0, s0) : 0.0f;
            wts[(g8 + 8) * L::GP + col] = has_hi ? __fdiv_rn(e1, s1) : 0.0f;
        }
    __syncwarp();

    // Phase D: out_i = sum_j w_ij (v_j + peb_ij), in slot order, v from GA.
    cp_wait_all();
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PER_WARP; ++u) {
        const int i = i0 + u;
        if (i >= M) break;
        for (int c = 2 * lane; c < C; c += 64) {
            uint32_t vr[K];
#pragma unroll
            for (int j = 0; j < K; ++j)
                vr[j] = smem_pair(GA, L::LDC, u * K + j, c);
            float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int r = u * K + j;
                const float w = wts[r * L::GP + c / 8];
                float2 v = make_float2(0.f, 0.f);
                if (nb[r] >= 0) v = with_bias(vr[j], par + L::VB, c);
                const float2 pe = unpack2(
                    *reinterpret_cast<const uint32_t*>(PEB + r * L::LDC + c));
                a0 = __fadd_rn(a0, __fmul_rn(__fadd_rn(v.x, pe.x), w));
                a1 = __fadd_rn(a1, __fmul_rn(__fadd_rn(v.y, pe.y), w));
            }
            *reinterpret_cast<float2*>(out + (size_t)i * C + c) =
                make_float2(a0, a1);
        }
    }
}

template <int C, int K>
int launch(const Params& p, cudaStream_t stream) {
    using L = Layout<C>;
    auto kernel = gva_kernel<C, K>;
    static int ready = -1;
    if (ready != 0 &&
        (ready = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             L::TOTAL)) != 0)
        return ready;
    const int rows = L::WARPS * (16 / K);
    const long long blocks = ((long long)p.M + rows - 1) / rows;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, L::THREADS, L::TOTAL, stream>>>(p);
    return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// 0: the tensors a call takes; 1: the padding of a shared row.
int gva_const(int which) {
    switch (which) {
        case 0: return N_TENSORS;
        case 1: return PAD;
        default: return -1;
    }
}

// At width C: 0 the warps of a block, 1 pe2's rows a chunk, 2 we1's rows a
// chunk, 3 its dynamic shared memory (bytes); -1 for a width not built.
int gva_shape(int C, int which) {
#define GVA_SHAPE(c, w, ncp, ncw)                                      \
    if (C == c) {                                                      \
        const int v[4] = {w, ncp, ncw, Layout<c>::TOTAL};              \
        return which >= 0 && which < 4 ? v[which] : -1;                \
    }
    GVA_WIDTHS(GVA_SHAPE)
#undef GVA_SHAPE
    return -1;
}

// One GVA: T, a host array of gva_const(0) device pointers in ops/gva.py's
// TENSORS order (Q, K, V (M, C) bf16 products without bias; NBR (M, LD)
// int64 whose first K columns are the neighbours, -1 missing; XYZ (M, 3)
// f32; the module's f32 parameters, contiguous; OUT (M, C) f32; COUNTERS
// three int64 (real neighbour slots, slots M K, rows skipped) or null).
// C in GVA_WIDTHS, G = C / 8, K 8 or 16.
int gva(const void* const* T, int M, int LD, int K, int C, int G,
        cudaStream_t stream) {
    if (M < 1 || (K != 8 && K != 16) || LD < K || G * 8 != C)
        return (int)cudaErrorInvalidValue;
    Params p;
    for (int i = 0; i < N_TENSORS; ++i) {
        p.t[i] = T[i];
        if (!T[i] && i != T_COUNTERS) return (int)cudaErrorInvalidValue;
    }
    if (!aligned(T[T_Q], 16) || !aligned(T[T_K], 16) || !aligned(T[T_V], 16) ||
        !aligned(T[T_PE2W], 16) || !aligned(T[T_WE1W], 16) ||
        !aligned(T[T_OUT], 8) || !aligned(T[T_NBR], 8))
        return (int)cudaErrorInvalidValue;
    p.M = M;
    p.ld = LD;
#define GVA_LAUNCH(c, w, ncp, ncw)                             \
    if (C == c) return K == 8 ? launch<c, 8>(p, stream)        \
                              : launch<c, 16>(p, stream);
    GVA_WIDTHS(GVA_LAUNCH)
#undef GVA_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
