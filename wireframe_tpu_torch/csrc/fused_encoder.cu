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
//   (a) k1_gemm_bias: the tiled WMMA GEMM + bias of wmma_gemm.cuh
//       (bf16 operands, f32 accumulators, 128x128x32 block tiles).  A is
//       bf16, or f32 for the first stage (the raw (B*N, 8) cloud, rounded
//       to bf16 on load exactly as `x.astype(bf16)`).  Used for the 4
//       stages and the projection.
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
#include <stdint.h>

#include "wmma_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_SENTINEL = -1e30f;

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
    const bf16* w = static_cast<const bf16*>(W);
    if (a_is_f32)
        return wgemm::launch_gemm<float, false, false>(
            static_cast<const float*>(A), w, bias, C, M, N, K, 1, K, stream);
    return wgemm::launch_gemm<bf16, false, false>(
        static_cast<const bf16*>(A), w, bias, C, M, N, K, 1, K, stream);
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
