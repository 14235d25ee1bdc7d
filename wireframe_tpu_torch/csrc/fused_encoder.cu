// K1: the fused point encoder, hand-written for Hopper (sm_90a).
//
// Replaces wireframe_tpu/ops/pallas_encoder.py:fused_point_encoder, the
// inference encoder of the serving path.  Per point:
//   4 x [Linear (bf16 operands, f32 accumulation) + bias -> LayerNorm
//        (eps 1e-6, f32 statistics) -> ReLU -> bf16],
//   then Linear 1024 -> 512 + bias in f32;
// then over the point axis: masked sum / max (-1e30 sentinel, an empty
// cloud gives 0), unmasked sum / max (padding rows INCLUDED: they carry
// bias + LayerNorm output, not zeros), the valid count, and the optional
// kv window masked max over `p` consecutive rows (an empty window gives 0).
//
// What bounds it on this card: operations.  The chain is
//   2 * (8*512 + 512*1024 + 1024*2048 + 2048*1024 + 1024*512)
//   = 10.49 MFLOP per point
// against ~32 B of input per point plus 10.5 MB of bf16 weights read once,
// far above the H100's ~295 FLOP/B ridge point, so the tensor cores are the
// limit (989 TFLOP/s bf16 dense).
//
// Design of this first version (right and simple first):
//   (a) k1_gemm_bias: one tiled GEMM + bias, bf16 operands staged through
//       shared memory, nvcuda::wmma 16x16x16 bf16 tiles with f32
//       accumulators, 128x128x32 block tiles, two shared-memory stages fed
//       by register prefetch.  The ragged M / N / K edges are masked on
//       load (zero fill) and on store.  A is bf16, or f32 for the first
//       stage (the raw (B*N, 8) cloud, rounded to bf16 on load exactly as
//       `x.astype(bf16)`).  Used for the 4 stages and the projection.
//   (b) k1_ln_relu: one warp per row, two-pass f32 mean / variance as in
//       pallas_encoder.py:_ln, ReLU, rounded to bf16.
//   (c) k1_pool_partials + k1_pool_finalize: the validity mask from the
//       RAW f32 input row (|sum x| > 1e-9, pallas_encoder.py:168), the kv
//       window masked max, per-(sample, row-chunk) partial pools, then a
//       second pass that reduces the partials in a fixed order.  No float
//       atomics anywhere, so results are identical run to run.
// The intermediate activations go through device memory: at B=3,
// N=16384 the widest is 49152 x 2048 x 4 B = 0.4 GB.  The planned
// redesign keeps them on chip instead: a persistent CTA per point tile
// that runs the whole chain with wgmma, weight tiles streamed by TMA
// through a shared-memory ring, the LayerNorm row statistics taken in the
// GEMM epilogue and applied as the next stage loads its operand, and the
// pools accumulated in registers, so only the cloud is read and only the
// pools and kv tokens are written.
//
// Interface: plain C, loaded with ctypes.  Every function launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError()
// so a refused launch is reported by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int GEMM_THREADS = 256;         // 8 warps: 2 (rows) x 4 (cols)
constexpr int WARP_M = 64;                // each warp: 64 x 32 outputs
constexpr int WARP_N = 32;
constexpr int FRAG_M = WARP_M / 16;       // 4
constexpr int FRAG_N = WARP_N / 16;       // 2
constexpr int A_LD = BK + 8;              // padded leading dims (bf16)
constexpr int B_LD = BN + 8;
constexpr float NEG_SENTINEL = -1e30f;

__device__ __forceinline__ uint4 pack8(const float* v) {
    uint4 out;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return out;
}

// 8 consecutive A elements (row, col..col+7) as bf16, zero outside.
__device__ __forceinline__ uint4 load_a8(const bf16* A, int M, int K,
                                         int row, int col) {
    if (row < M && col + 8 <= K && (K & 7) == 0)
        return *reinterpret_cast<const uint4*>(A + (size_t)row * K + col);
    uint4 out;
    bf16* p = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int e = 0; e < 8; ++e)
        p[e] = (row < M && col + e < K) ? A[(size_t)row * K + col + e]
                                        : __float2bfloat16(0.0f);
    return out;
}

__device__ __forceinline__ uint4 load_a8(const float* A, int M, int K,
                                         int row, int col) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
        v[e] = (row < M && col + e < K) ? A[(size_t)row * K + col + e]
                                        : 0.0f;
    return pack8(v);
}

// 8 consecutive W elements (k, col..col+7) of the row-major (K, N) weight.
__device__ __forceinline__ uint4 load_b8(const bf16* W, int K, int N,
                                         int k, int col) {
    if (k < K && col + 8 <= N && (N & 7) == 0)
        return *reinterpret_cast<const uint4*>(W + (size_t)k * N + col);
    uint4 out;
    bf16* p = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int e = 0; e < 8; ++e)
        p[e] = (k < K && col + e < N) ? W[(size_t)k * N + col + e]
                                      : __float2bfloat16(0.0f);
    return out;
}

// C (M, N) f32 = A (M, K) @ W (K, N) + bias (N,), row-major throughout.
template <typename TA>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bias_kernel(const TA* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ C,
                 int M, int N, int K) {
    __shared__ __align__(128) bf16 sA[2][BM * A_LD];
    __shared__ __align__(128) bf16 sB[2][BK * B_LD];
    __shared__ __align__(128) float sOut[GEMM_THREADS / 32][16 * 16];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int wm = warp >> 2;             // 0..1
    const int wn = warp & 3;              // 0..3
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAG_M][FRAG_N];
#pragma unroll
    for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
        for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // Each thread moves 2 vectors of 8 bf16 for A (128 x 32) and for
    // B (32 x 128) per k-tile.
    uint4 ra[2], rb[2];
    auto load_regs = [&](int kt) {
        const int k0 = kt * BK;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int v = tid + i * GEMM_THREADS;
            ra[i] = load_a8(A, M, K, m0 + v / (BK / 8), k0 + (v % (BK / 8)) * 8);
            rb[i] = load_b8(W, K, N, k0 + v / (BN / 8), n0 + (v % (BN / 8)) * 8);
        }
    };
    auto store_smem = [&](int buf) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int v = tid + i * GEMM_THREADS;
            *reinterpret_cast<uint4*>(
                &sA[buf][(v / (BK / 8)) * A_LD + (v % (BK / 8)) * 8]) = ra[i];
            *reinterpret_cast<uint4*>(
                &sB[buf][(v / (BN / 8)) * B_LD + (v % (BN / 8)) * 8]) = rb[i];
        }
    };

    const int nk = (K + BK - 1) / BK;
    load_regs(0);
    store_smem(0);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
        const int cur = kt & 1;
        if (kt + 1 < nk) load_regs(kt + 1);   // global loads in flight
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                fa[FRAG_M];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                fb[FRAG_N];
#pragma unroll
            for (int i = 0; i < FRAG_M; ++i)
                wmma::load_matrix_sync(
                    fa[i], &sA[cur][(wm * WARP_M + i * 16) * A_LD + kk], A_LD);
#pragma unroll
            for (int j = 0; j < FRAG_N; ++j)
                wmma::load_matrix_sync(
                    fb[j], &sB[cur][kk * B_LD + wn * WARP_N + j * 16], B_LD);
#pragma unroll
            for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
                for (int j = 0; j < FRAG_N; ++j)
                    wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        if (kt + 1 < nk) store_smem(cur ^ 1);
        __syncthreads();
    }

    // Epilogue: each warp stages one 16x16 accumulator at a time through
    // its own shared-memory tile, adds the bias and stores in bounds.
    float* stage = sOut[warp];
#pragma unroll
    for (int i = 0; i < FRAG_M; ++i) {
#pragma unroll
        for (int j = 0; j < FRAG_N; ++j) {
            wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int row0 = m0 + wm * WARP_M + i * 16;
            const int col0 = n0 + wn * WARP_N + j * 16;
#pragma unroll
            for (int t = 0; t < 8; ++t) {
                const int e = lane + t * 32;
                const int r = row0 + e / 16;
                const int c = col0 + e % 16;
                if (r < M && c < N)
                    C[(size_t)r * N + c] = stage[e] + bias[c];
            }
            __syncwarp();
        }
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// H (M, W) bf16 = bf16(relu(LayerNorm(Z) * gamma + beta)); one warp a row.
// W % 4 == 0 (checked by the caller).
__global__ void ln_relu_kernel(const float* __restrict__ Z,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               bf16* __restrict__ H, int M, int W) {
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const float4* z = reinterpret_cast<const float4*>(Z + (size_t)row * W);
    const int w4 = W >> 2;
    float s = 0.0f;
    for (int c = lane; c < w4; c += 32) {
        const float4 v = z[c];
        s += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = warp_sum(s) / (float)W;
    float q = 0.0f;
    for (int c = lane; c < w4; c += 32) {
        const float4 v = z[c];
        const float a = v.x - mean, b = v.y - mean;
        const float cc = v.z - mean, d = v.w - mean;
        q += (a * a + b * b) + (cc * cc + d * d);
    }
    const float var = warp_sum(q) / (float)W;
    const float rstd = rsqrtf(var + 1e-6f);
    const float4* g4 = reinterpret_cast<const float4*>(gamma);
    const float4* b4 = reinterpret_cast<const float4*>(beta);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(H + (size_t)row * W);
    for (int c = lane; c < w4; c += 32) {
        const float4 v = z[c];
        const float4 g = g4[c];
        const float4 bb = b4[c];
        const float y0 = fmaxf((v.x - mean) * rstd * g.x + bb.x, 0.0f);
        const float y1 = fmaxf((v.y - mean) * rstd * g.y + bb.y, 0.0f);
        const float y2 = fmaxf((v.z - mean) * rstd * g.z + bb.z, 0.0f);
        const float y3 = fmaxf((v.w - mean) * rstd * g.w + bb.w, 0.0f);
        h[2 * c] = __floats2bfloat162_rn(y0, y1);
        h[2 * c + 1] = __floats2bfloat162_rn(y2, y3);
    }
}

constexpr int POOL_THREADS = 128;
constexpr int MAX_CHUNK = 1024;

// One block per (row chunk, sample, 128 channels).  Rows are walked in
// order, so partials are a fixed function of the inputs.
// part: (B, nchunks, 5, C) = masked sum, masked max, sum, max, count.
// kv:   (B, N / p, C) when p > 0 (chunk % p == 0, N % p == 0).
__global__ void pool_partials_kernel(const float* __restrict__ X, int D,
                                     const float* __restrict__ F,
                                     float* __restrict__ kv,
                                     float* __restrict__ part,
                                     int N, int C, int p, int chunk) {
    __shared__ float smask[MAX_CHUNK];
    const int ch = blockIdx.x;
    const int b = blockIdx.y;
    const int nchunks = gridDim.x;
    const int r0 = ch * chunk;
    const int r1 = min(N, r0 + chunk);
    for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
        const float* xr = X + ((size_t)b * N + r) * D;
        float s = 0.0f;
        for (int d = 0; d < D; ++d) s += xr[d];
        smask[r - r0] = fabsf(s) > 1e-9f ? 1.0f : 0.0f;
    }
    __syncthreads();
    const int c = blockIdx.z * POOL_THREADS + threadIdx.x;
    if (c >= C) return;
    float msum = 0.0f, mmax = NEG_SENTINEL, usum = 0.0f, umax = NEG_SENTINEL;
    float cnt = 0.0f, wmax = NEG_SENTINEL;
    const float* fcol = F + (size_t)b * N * C + c;
    for (int r = r0; r < r1; ++r) {
        const float f = fcol[(size_t)r * C];
        usum += f;
        umax = fmaxf(umax, f);
        if (smask[r - r0] != 0.0f) {
            msum += f;
            mmax = fmaxf(mmax, f);
            cnt += 1.0f;
            wmax = fmaxf(wmax, f);
        }
        if (p > 0 && (r + 1) % p == 0) {
            kv[((size_t)b * (N / p) + r / p) * C + c] =
                wmax > NEG_SENTINEL / 2 ? wmax : 0.0f;
            wmax = NEG_SENTINEL;
        }
    }
    float* out = part + ((size_t)b * nchunks + ch) * 5 * C + c;
    out[0 * C] = msum;
    out[1 * C] = mmax;
    out[2 * C] = usum;
    out[3 * C] = umax;
    out[4 * C] = cnt;
}

// pools (B, 4, C) = masked mean, masked max, mean, max.
__global__ void pool_finalize_kernel(const float* __restrict__ part,
                                     float* __restrict__ pools,
                                     int nchunks, int N, int C) {
    const int b = blockIdx.x;
    const int c = blockIdx.y * POOL_THREADS + threadIdx.x;
    if (c >= C) return;
    float msum = 0.0f, mmax = NEG_SENTINEL, usum = 0.0f, umax = NEG_SENTINEL;
    float cnt = 0.0f;
    for (int ch = 0; ch < nchunks; ++ch) {
        const float* in = part + ((size_t)b * nchunks + ch) * 5 * C + c;
        msum += in[0 * C];
        mmax = fmaxf(mmax, in[1 * C]);
        usum += in[2 * C];
        umax = fmaxf(umax, in[3 * C]);
        cnt += in[4 * C];
    }
    float* out = pools + (size_t)b * 4 * C + c;
    out[0 * C] = msum / fmaxf(cnt, 1.0f);
    out[1 * C] = mmax > NEG_SENTINEL / 2 ? mmax : 0.0f;
    out[2 * C] = usum / (float)N;
    out[3 * C] = umax;
}

}  // namespace

extern "C" {

int k1_gemm_bias(const void* A, int a_is_f32, const void* W, const float* bias,
                 float* C, int M, int N, int K, cudaStream_t stream) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (a_is_f32)
        gemm_bias_kernel<float><<<grid, GEMM_THREADS, 0, stream>>>(
            static_cast<const float*>(A), static_cast<const bf16*>(W), bias,
            C, M, N, K);
    else
        gemm_bias_kernel<bf16><<<grid, GEMM_THREADS, 0, stream>>>(
            static_cast<const bf16*>(A), static_cast<const bf16*>(W), bias,
            C, M, N, K);
    return (int)cudaGetLastError();
}

int k1_ln_relu(const float* Z, const float* gamma, const float* beta,
               void* H, int M, int W, cudaStream_t stream) {
    constexpr int rows_per_block = 8;
    const dim3 grid((M + rows_per_block - 1) / rows_per_block);
    ln_relu_kernel<<<grid, rows_per_block * 32, 0, stream>>>(
        Z, gamma, beta, static_cast<bf16*>(H), M, W);
    return (int)cudaGetLastError();
}

int k1_pool(const float* X, int D, const float* F, float* kv, float* part,
            float* pools, int B, int N, int C, int p, int chunk,
            cudaStream_t stream) {
    if (chunk <= 0 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
    const int nchunks = (N + chunk - 1) / chunk;
    const int cblocks = (C + POOL_THREADS - 1) / POOL_THREADS;
    pool_partials_kernel<<<dim3(nchunks, B, cblocks), POOL_THREADS, 0,
                           stream>>>(X, D, F, kv, part, N, C, p, chunk);
    int err = (int)cudaGetLastError();
    if (err) return err;
    pool_finalize_kernel<<<dim3(B, cblocks), POOL_THREADS, 0, stream>>>(
        part, pools, nchunks, N, C);
    return (int)cudaGetLastError();
}

}  // extern "C"
