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
// The same in f32 (compute_dtype=float32, the `_f32` functions): f32
// operands and h, f32 accumulation (hopper_gemm.cuh's 3xTF32 main loop).
//
// What bounds it on this card: operations.  The chain is
//   2 * (8*512 + 512*1024 + 1024*2048 + 2048*1024 + 1024*512)
//   = 10.49 MFLOP per point
// against ~32 B of input per point plus 10.5 MB of bf16 weights read once,
// far above the H100's ~295 FLOP/B ridge point, so the tensor cores are the
// limit (989 TFLOP/s bf16 dense); in f32 the same tensor cores in TF32,
// three products each (494.7 / 3 TFLOP/s of f32 work).
//
// Design: every product goes through the warp-specialised wgmma + TMA
// GEMM of hopper_gemm.cuh, stage by stage, so the only activation in
// device memory is each stage's h (18.4 KB a point in all in bf16, 36.9
// KB in f32):
//   k1_prep     x in the compute dtype with rows padded to 8 elements
//               (TMA's 16-byte rows) and each row's validity from the
//               RAW f32 row (|sum x| > 1e-9, pallas_encoder.py:168): the
//               chain kernels' own input pass, so stage 0 reads the same x;
//   k1_stage    one stage: z = h W + b with LayerNorm + ReLU -> h in the
//               epilogue, across a cluster of ceil(W / 256) CTAs (W <=
//               2048); f32 z never reaches device memory.  It is K5's
//               forward stage (the same kernel with a null z), so K1's h
//               equals K5's bit for bit;
//   k1_gemm_z   a stage wider than 2048 (split): z = h W + b in f32 to
//               device memory (the GEMM's STORE epilogue), then
//               layernorm_rows.cu's forward row kernel writes h; K5's
//               forward runs the same two kernels on such a stage;
//   k1_project  the projection with the POOL epilogue: f = acc + b, per
//               (cloud, 128-row tile) partial pools and the kv windows
//               straight to kv_features; the (B, N, 512) f32 features
//               only when the caller asks for them (then equal to K5's
//               forward features bit for bit) or, in f32, when the last
//               stage is wider than 2048 (the main loop's flushes park
//               their sums there);
//   k1_finalize per cloud, the tiles' partials summed in tile order, and
//               the kv windows that cross a tile boundary merged from the
//               tiles' edge partials.
// Seven launches a call (one more per split stage), no float atomics:
// runs repeat bit for bit.
// Stages run one after another rather than a whole chain per CTA: a
// 128-row tile of the 2048-wide stage is 512 KB in bf16, more than twice
// a CTA's 227 KB of shared memory, and each tile would re-read all 10.5 MB
// of weights.
//
// Interface: plain C, loaded with ctypes.  Every function launches on the
// stream it is given, allocates nothing, and returns a cudaError_t so a
// refused launch is reported by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

// The finalize is a short serial sum per (cloud, channel): small blocks
// spread it over more SMs, and the unrolled tile loop keeps that many
// loads in flight.
constexpr int POOL_THREADS = 32;

// pools (B, 4, C) = masked mean, masked max, mean, max from the partials
// part (B, tiles, 5, C); then, with edge partials (B, tiles, 2, C), the kv
// windows of p rows that cross a tile boundary: slot 1 of the tile where
// the window begins, slot 0 of every later tile it reaches.
__global__ void k1_finalize_kernel(const float* __restrict__ part,
                                   const float* __restrict__ edge,
                                   float* __restrict__ kv,
                                   float* __restrict__ pools, int tiles,
                                   int rows, int p, int C) {
    constexpr int BM = hgemm::BM;
    const float NEG = hgemm::NEG_SENTINEL;
    const int b = blockIdx.y;
    const int c = blockIdx.x * POOL_THREADS + threadIdx.x;
    if (c >= C) return;
    float msum = 0.0f, mmax = NEG, usum = 0.0f, umax = NEG, cnt = 0.0f;
#pragma unroll 16
    for (int t = 0; t < tiles; ++t) {
        const float* in = part + ((size_t)b * tiles + t) * 5 * C + c;
        msum += in[0];
        mmax = fmaxf(mmax, in[C]);
        usum += in[2 * C];
        umax = fmaxf(umax, in[3 * C]);
        cnt += in[4 * C];
    }
    float* out = pools + (size_t)b * 4 * C + c;
    out[0] = msum / fmaxf(cnt, 1.0f);
    out[C] = mmax > NEG / 2 ? mmax : 0.0f;
    out[2 * C] = usum / (float)rows;
    out[3 * C] = umax;
    if (edge == nullptr) return;
    for (int k = 1; k < tiles; ++k) {
        const int w = k * BM / p;               // the window at boundary k
        if (k * BM % p == 0 || w * p < (k - 1) * BM) continue;
        float m = edge[(((size_t)b * tiles + k - 1) * 2 + 1) * C + c];
        for (int j = k; j < tiles && j * BM < (w + 1) * p; ++j)
            m = fmaxf(m, edge[(((size_t)b * tiles + j) * 2) * C + c]);
        kv[((size_t)b * (rows / p) + w) * C + c] = m > NEG / 2 ? m : 0.0f;
    }
}

}  // namespace

extern "C" {

// The GEMM's row tile, for the caller's plan.
int k1_row_tile() { return hgemm::BM; }

// k1_prep, k1_stage, k1_gemm_z and k1_project each have an `_f32` twin
// with the same arguments whose operands and h are f32.

// The cloud in the compute dtype and each row's validity; see
// hgemm::prep_x.
int k1_prep(const float* X, int D, void* xb, int ldx, uint8_t* valid, int M,
            cudaStream_t stream) {
    return hgemm::prep_x(X, D, static_cast<bf16*>(xb), ldx, valid, M, stream);
}
int k1_prep_f32(const float* X, int D, void* xb, int ldx, uint8_t* valid,
                int M, cudaStream_t stream) {
    return hgemm::prep_x(X, D, static_cast<float*>(xb), ldx, valid, M,
                         stream);
}

// One stage: H = relu(LayerNorm(A W + b)); see hgemm::gemm_ln_fwd.
int k1_stage(const void* A, int lda, const void* W, int ldw,
             const float* bias, const float* gamma, const float* beta,
             void* H, int ldh, int M, int N, int K, cudaStream_t stream) {
    return hgemm::gemm_ln_fwd(A, lda, W, ldw, bias, gamma, beta, H, ldh,
                              nullptr, 0, 0, M, N, K, false, stream);
}
int k1_stage_f32(const void* A, int lda, const void* W, int ldw,
                 const float* bias, const float* gamma, const float* beta,
                 void* H, int ldh, int M, int N, int K, cudaStream_t stream) {
    return hgemm::gemm_ln_fwd(A, lda, W, ldw, bias, gamma, beta, H, ldh,
                              nullptr, 0, 0, M, N, K, true, stream);
}

// A split stage's product: Z (f32, row stride ldz) = A W + b; see
// hgemm::gemm_store.
int k1_gemm_z(const void* A, int lda, const void* W, int ldw,
              const float* bias, float* Z, int ldz, int M, int N, int K,
              cudaStream_t stream) {
    return hgemm::gemm_store(hgemm::FWD, A, lda, W, ldw, bias, Z, ldz, M, N,
                             K, 1, K, false, stream);
}
int k1_gemm_z_f32(const void* A, int lda, const void* W, int ldw,
                  const float* bias, float* Z, int ldz, int M, int N, int K,
                  cudaStream_t stream) {
    return hgemm::gemm_store(hgemm::FWD, A, lda, W, ldw, bias, Z, ldz, M, N,
                             K, 1, K, true, stream);
}

// The projection and its pools; see hgemm::gemm_pool.
int k1_project(const void* A, int lda, const void* W, int ldw,
               const float* bias, const uint8_t* valid, float* F, int ldf,
               float* part, float* kv, float* edge, int p, int clouds,
               int rows, int N, int K, cudaStream_t stream) {
    return hgemm::gemm_pool(A, lda, W, ldw, bias, valid, F, ldf, part, kv,
                            edge, p, clouds, rows, N, K, false, stream);
}
int k1_project_f32(const void* A, int lda, const void* W, int ldw,
                   const float* bias, const uint8_t* valid, float* F,
                   int ldf, float* part, float* kv, float* edge, int p,
                   int clouds, int rows, int N, int K, cudaStream_t stream) {
    return hgemm::gemm_pool(A, lda, W, ldw, bias, valid, F, ldf, part, kv,
                            edge, p, clouds, rows, N, K, true, stream);
}

int k1_finalize(const float* part, const float* edge, float* kv,
                float* pools, int clouds, int rows, int p, int C,
                cudaStream_t stream) {
    const int tiles = (rows + hgemm::BM - 1) / hgemm::BM;
    if (edge != nullptr && (kv == nullptr || p < 1))
        return (int)cudaErrorInvalidValue;
    k1_finalize_kernel<<<dim3((C + POOL_THREADS - 1) / POOL_THREADS, clouds),
                         POOL_THREADS, 0, stream>>>(part, edge, kv, pools,
                                                    tiles, rows, p, C);
    return (int)cudaGetLastError();
}

}  // extern "C"
