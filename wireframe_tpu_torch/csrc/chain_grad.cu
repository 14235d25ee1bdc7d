// K2 + K3 + K5: the differentiable point chain of the training step,
// hand-written for Hopper (sm_90a).
//
// Replaces wireframe_tpu/ops/pallas_chain_grad.py:
//   K2 _chain_forward_stash_pallas (forward, stashing the pre-LayerNorm
//      activations z_k in bf16, with the kv window max / argmax / masked
//      window sum of _kv_pool_tile_fwd);
//   K3 _chain_backward_pallas with zs (backward from the stash: the kv
//      cotangent scatter of _kv_pool_tile_bwd, LayerNorm statistics
//      rebuilt from the bf16 z (_stages_from_z), then per stage the ReLU
//      backward with jnp.maximum's tie rule, the LayerNorm backward,
//      dW = h^T dz and dh = dz W^T; f32 parameter gradients);
//   K5 _chain_forward_pallas (the same forward without the stash) and
//      _chain_backward_pallas with zs=None (_recompute_stages: each
//      stage's z recomputed by the forward's own GEMM and LayerNorm pass,
//      so z and h are bit-identical to the forward's, the statistics taken
//      from the f32 z; then K3's stage backward on the f32 z).
//
// What bounds it on this card: operations.  The forward is the same
// 10.49 MFLOP per point as K1, K3 twice that (dW and dh) and K5's
// backward three times (recompute, dW, dh), while the stash is 2 B per
// activation (189 MB at B=8, N=2560): ~0.06 ms at 3.35 TB/s against
// ~0.22 ms of bf16 tensor-core time for the forward.
//
// Design of this first version (right and simple first):
//   - every product goes through the WMMA GEMM of wmma_gemm.cuh, in the
//     three forms the chain needs: A B + bias (forward), dz W^T (B read
//     transposed) and h^T dz (A read transposed, split over the 20,480
//     rows with per-slice partials summed in a fixed order);
//   - k2_ln_relu_stash: one warp per row, the forward's two-pass f32
//     LayerNorm of z (f32), ReLU -> bf16 h, and (K2 only; a null Zs
//     skips it) the bf16 stash of z;
//   - k2_window_pool: one thread per (window, channel): masked max with
//     the lowest tied offset as argmax (0 for an all-invalid window, as
//     jnp.argmax over all -inf gives 0) and the masked window sum;
//   - k3_seed: the kv cotangent scatter (+ the feature cotangent when the
//     flavour has one) -> bf16 cotangent and per-block column partials of
//     d final_b;
//   - k3_row_bwd / k5_row_bwd: one 256-thread block per 32-row chunk,
//     each thread owning up to 8 columns: LayerNorm statistics from the
//     bf16 (K3) or f32 (K5) z, h = relu(ln) in bf16 (the next stage's
//     GEMM input; K5 keeps the recomputed h and passes a null Hout), the
//     ReLU / LN backward, dz in bf16, and per-block column partials of
//     d gamma, d beta, d b;
//   - k3_colsum: sums per-block (or per-K-slice) partials in block order.
// No float atomics anywhere: gradients repeat bit for bit run to run.
// Activations go through device memory; keeping them on chip is the work
// of K1's planned redesign (ROADMAP.md K1+).  K5's backward holds the
// whole batch's recomputed f32 z and bf16 h for the length of the call.
//
// Interface: plain C, loaded with ctypes.  Every function launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wmma_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int ROW_THREADS = 256;
constexpr int ROW_CHUNK = 32;          // rows per k3_row_bwd / k3_seed block
constexpr int MAX_COLS_PER_THREAD = 8; // widths up to 2048
constexpr int POOL_THREADS = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Block-wide sums of two values (ROW_THREADS threads); every thread gets
// both totals.  `red` holds 2 * (ROW_THREADS / 32) floats.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    a = warp_sum(a);
    b = warp_sum(b);
    __syncthreads();                     // red is free (previous use done)
    if (lane == 0) {
        red[2 * warp] = a;
        red[2 * warp + 1] = b;
    }
    __syncthreads();
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int w = 0; w < ROW_THREADS / 32; ++w) {
        sa += red[2 * w];
        sb += red[2 * w + 1];
    }
    return make_float2(sa, sb);
}

// valid[r] = |sum_d X[r, d]| > 1e-9 (the encoder's validity mask, from the
// RAW f32 row).
__global__ void row_valid_kernel(const float* __restrict__ X, int D,
                                 uint8_t* __restrict__ valid, int M) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= M) return;
    const float* xr = X + (size_t)r * D;
    float s = 0.0f;
    for (int d = 0; d < D; ++d) s += xr[d];
    valid[r] = fabsf(s) > 1e-9f ? 1 : 0;
}

// Forward LayerNorm of one stage, one warp a row:
//   H = bf16(relu((Z - mean) * rstd * gamma + beta)),  Zs = bf16(Z)
// (Zs null: no stash).
__global__ void ln_relu_stash_kernel(const float* __restrict__ Z,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     bf16* __restrict__ H,
                                     bf16* __restrict__ Zs, int M, int W) {
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const float* z = Z + (size_t)row * W;
    float s = 0.0f;
    for (int c = lane; c < W; c += 32) s += z[c];
    const float mean = warp_sum(s) / (float)W;
    float q = 0.0f;
    for (int c = lane; c < W; c += 32) {
        const float d = z[c] - mean;
        q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)W + 1e-6f);
    bf16* h = H + (size_t)row * W;
    bf16* zs = Zs == nullptr ? nullptr : Zs + (size_t)row * W;
    for (int c = lane; c < W; c += 32) {
        const float v = z[c];
        h[c] = __float2bfloat16(fmaxf((v - mean) * rstd * gamma[c] + beta[c],
                                      0.0f));
        if (zs != nullptr) zs[c] = __float2bfloat16(v);
    }
}

// Masked window pool of the features F (B*N, C) over windows of p
// consecutive rows (windows never straddle clouds: N % p == 0).
// grid (ceil(C / POOL_THREADS), windows).
__global__ void window_pool_kernel(const float* __restrict__ F,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ pooled,
                                   int* __restrict__ idx,
                                   float* __restrict__ sums, int C, int p) {
    const int w = blockIdx.y;
    const int c = blockIdx.x * POOL_THREADS + threadIdx.x;
    if (c >= C) return;
    float pm = -INFINITY, s = 0.0f;
    int arg = 0;
    for (int o = 0; o < p; ++o) {
        const int r = w * p + o;
        if (!valid[r]) continue;
        const float f = F[(size_t)r * C + c];
        if (f > pm) {           // strict: the lowest tied offset wins
            pm = f;
            arg = o;
        }
        s += f;
    }
    const size_t out = (size_t)w * C + c;
    pooled[out] = isfinite(pm) ? pm : 0.0f;
    idx[out] = arg;
    sums[out] = s;
}

// Cotangent of the projection output, per row n of window w = n / p,
// offset o = n % p:
//   g[n, c] = (window w has a valid row && idx[w, c] == o ? dpool[w, c] : 0)
//           + (row n valid ? dsums[w, c] : 0)   [kv flavours]
//           (+ gfeat[n, c] when the flavour returns features)
// Written in bf16 for both GEMMs; block column partials of the f32 sum for
// d final_b.  One block per ROW_CHUNK rows.
__global__ void seed_kernel(const float* __restrict__ dpool,
                            const int* __restrict__ idx,
                            const float* __restrict__ dsums,
                            const uint8_t* __restrict__ valid,
                            const float* __restrict__ gfeat,
                            bf16* __restrict__ gbf,
                            float* __restrict__ part, int M, int C, int p) {
    const int r0 = blockIdx.x * ROW_CHUNK;
    const int r1 = min(M, r0 + ROW_CHUNK);
    float acc[MAX_COLS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) acc[j] = 0.0f;
    for (int r = r0; r < r1; ++r) {
        int w = 0, o = 0;
        bool win_valid = false, row_valid = false;
        if (p > 0) {
            w = r / p;
            o = r % p;
            for (int q = 0; q < p; ++q) win_valid |= valid[w * p + q] != 0;
            row_valid = valid[r] != 0;
        }
#pragma unroll
        for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
            const int c = threadIdx.x + j * ROW_THREADS;
            if (c >= C) break;
            float g = 0.0f;
            if (p > 0) {
                const size_t wc = (size_t)w * C + c;
                const float dp = win_valid ? dpool[wc] : 0.0f;
                const float scat = idx[wc] == o ? dp : 0.0f;
                g = scat + (row_valid ? dsums[wc] : 0.0f);
                if (gfeat != nullptr) g = g + gfeat[(size_t)r * C + c];
            } else {
                g = gfeat[(size_t)r * C + c];
            }
            acc[j] += g;
            gbf[(size_t)r * C + c] = __float2bfloat16(g);
        }
    }
#pragma unroll
    for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
        const int c = threadIdx.x + j * ROW_THREADS;
        if (c < C) part[(size_t)blockIdx.x * C + c] = acc[j];
    }
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Backward of one stage from its pre-LN activations Zs (M, W), bf16 (the
// K3 stash) or f32 (K5's recompute):
//   xhat = (z - mean) * rstd, ln = xhat * gamma + beta,
//   Hout = bf16(max(ln, 0))     (next stage's input; skipped when null),
//   dln  = ln > 0 ? dh : (ln < 0 ? 0 : dh / 2)    (jnp.maximum's tie rule),
//   dxhat = dln * gamma,
//   dz = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd -> bf16,
// and per-block column partials part[blk] = [d gamma | d beta | d b]
// (3 * W floats).  One block per ROW_CHUNK rows.
template <typename ZT>
__global__ void __launch_bounds__(ROW_THREADS)
row_bwd_kernel(const ZT* __restrict__ Zs, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ dh,
               bf16* __restrict__ dz_out, bf16* __restrict__ Hout,
               float* __restrict__ part, int M, int W) {
    __shared__ float red[2 * (ROW_THREADS / 32)];
    const int r0 = blockIdx.x * ROW_CHUNK;
    const int r1 = min(M, r0 + ROW_CHUNK);
    float gam[MAX_COLS_PER_THREAD], bet[MAX_COLS_PER_THREAD];
    float a_g[MAX_COLS_PER_THREAD], a_b[MAX_COLS_PER_THREAD],
        a_z[MAX_COLS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
        const int c = threadIdx.x + j * ROW_THREADS;
        gam[j] = c < W ? gamma[c] : 0.0f;
        bet[j] = c < W ? beta[c] : 0.0f;
        a_g[j] = a_b[j] = a_z[j] = 0.0f;
    }
    const float inv_w = 1.0f / (float)W;
    for (int r = r0; r < r1; ++r) {
        float z[MAX_COLS_PER_THREAD], g[MAX_COLS_PER_THREAD];
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
            const int c = threadIdx.x + j * ROW_THREADS;
            z[j] = c < W ? to_f32(Zs[(size_t)r * W + c]) : 0.0f;
            g[j] = c < W ? dh[(size_t)r * W + c] : 0.0f;
            s += z[j];
        }
        const float mean = block_sum2(s, 0.0f, red).x / (float)W;
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
            const int c = threadIdx.x + j * ROW_THREADS;
            const float d = z[j] - mean;
            q += c < W ? d * d : 0.0f;
        }
        const float rstd =
            rsqrtf(block_sum2(q, 0.0f, red).x / (float)W + 1e-6f);
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
            const int c = threadIdx.x + j * ROW_THREADS;
            const float xhat = (z[j] - mean) * rstd;
            const float ln = xhat * gam[j] + bet[j];
            const float dln = ln > 0.0f ? g[j] : (ln < 0.0f ? 0.0f
                                                            : 0.5f * g[j]);
            if (c < W) {
                if (Hout != nullptr)
                    Hout[(size_t)r * W + c] = __float2bfloat16(fmaxf(ln, 0.0f));
                a_g[j] += dln * xhat;
                a_b[j] += dln;
            }
            const float dxhat = dln * gam[j];
            z[j] = xhat;      // keep xhat and dxhat for the second pass
            g[j] = dxhat;
            s1 += c < W ? dxhat : 0.0f;
            s2 += c < W ? dxhat * xhat : 0.0f;
        }
        const float2 m = block_sum2(s1, s2, red);
        const float m1 = m.x * inv_w, m2 = m.y * inv_w;
#pragma unroll
        for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
            const int c = threadIdx.x + j * ROW_THREADS;
            if (c >= W) break;
            const float dz = (g[j] - m1 - z[j] * m2) * rstd;
            a_z[j] += dz;
            dz_out[(size_t)r * W + c] = __float2bfloat16(dz);
        }
    }
    float* out = part + (size_t)blockIdx.x * 3 * W;
#pragma unroll
    for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
        const int c = threadIdx.x + j * ROW_THREADS;
        if (c < W) {
            out[c] = a_g[j];
            out[W + c] = a_b[j];
            out[2 * W + c] = a_z[j];
        }
    }
}

// out[c] = sum over b < nparts, in order, of part[b * ncols + c].
__global__ void colsum_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int nparts,
                              long long ncols) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= ncols) return;
    float s = 0.0f;
    for (int b = 0; b < nparts; ++b) s += part[(long long)b * ncols + c];
    out[c] = s;
}

}  // namespace

extern "C" {

// Rows per k3_seed / k3_row_bwd block (the caller sizes the partials).
int k23_row_chunk() { return ROW_CHUNK; }
int k23_max_width() { return ROW_THREADS * MAX_COLS_PER_THREAD; }

// C = op(A) @ op(B) (+ bias); see wmma_gemm.cuh.  a_col / b_col select the
// transposed storage; splits > 1 writes `splits` partial products of
// ksplit K-rows each (ksplit a multiple of 32) to C[s * M * N].
int k23_gemm(const void* A, int a_is_f32, int a_col, const void* B,
             int b_col, const float* bias, float* C, int M, int N, int K,
             int splits, int ksplit, cudaStream_t stream) {
    const bf16* b = static_cast<const bf16*>(B);
    if (splits < 1 || (splits > 1 && ksplit % wgemm::BK))
        return (int)cudaErrorInvalidValue;
    if (a_is_f32) {
        const float* a = static_cast<const float*>(A);
        if (a_col && !b_col)
            return wgemm::launch_gemm<float, true, false>(
                a, b, bias, C, M, N, K, splits, ksplit, stream);
        if (!a_col && !b_col)
            return wgemm::launch_gemm<float, false, false>(
                a, b, bias, C, M, N, K, splits, ksplit, stream);
        return (int)cudaErrorInvalidValue;
    }
    const bf16* a = static_cast<const bf16*>(A);
    if (a_col && !b_col)
        return wgemm::launch_gemm<bf16, true, false>(
            a, b, bias, C, M, N, K, splits, ksplit, stream);
    if (!a_col && b_col)
        return wgemm::launch_gemm<bf16, false, true>(
            a, b, bias, C, M, N, K, splits, ksplit, stream);
    if (!a_col && !b_col)
        return wgemm::launch_gemm<bf16, false, false>(
            a, b, bias, C, M, N, K, splits, ksplit, stream);
    return (int)cudaErrorInvalidValue;
}

int k23_row_valid(const float* X, int D, uint8_t* valid, int M,
                  cudaStream_t stream) {
    row_valid_kernel<<<(M + 255) / 256, 256, 0, stream>>>(X, D, valid, M);
    return (int)cudaGetLastError();
}

int k2_ln_relu_stash(const float* Z, const float* gamma, const float* beta,
                     void* H, void* Zs, int M, int W, cudaStream_t stream) {
    constexpr int rows_per_block = 8;
    ln_relu_stash_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                           rows_per_block * 32, 0, stream>>>(
        Z, gamma, beta, static_cast<bf16*>(H), static_cast<bf16*>(Zs), M, W);
    return (int)cudaGetLastError();
}

int k2_window_pool(const float* F, const uint8_t* valid, float* pooled,
                   int* idx, float* sums, int windows, int C, int p,
                   cudaStream_t stream) {
    window_pool_kernel<<<dim3((C + POOL_THREADS - 1) / POOL_THREADS, windows),
                         POOL_THREADS, 0, stream>>>(F, valid, pooled, idx,
                                                    sums, C, p);
    return (int)cudaGetLastError();
}

int k3_seed(const float* dpool, const int* idx, const float* dsums,
            const uint8_t* valid, const float* gfeat, void* gbf, float* part,
            int M, int C, int p, cudaStream_t stream) {
    if (C > ROW_THREADS * MAX_COLS_PER_THREAD) return (int)cudaErrorInvalidValue;
    seed_kernel<<<(M + ROW_CHUNK - 1) / ROW_CHUNK, ROW_THREADS, 0, stream>>>(
        dpool, idx, dsums, valid, gfeat, static_cast<bf16*>(gbf), part, M, C,
        p);
    return (int)cudaGetLastError();
}

// Stage backward from the bf16 stash (K3).
int k3_row_bwd(const void* Zs, const float* gamma, const float* beta,
               const float* dh, void* dz, void* Hout, float* part, int M,
               int W, cudaStream_t stream) {
    if (W > ROW_THREADS * MAX_COLS_PER_THREAD) return (int)cudaErrorInvalidValue;
    row_bwd_kernel<bf16><<<(M + ROW_CHUNK - 1) / ROW_CHUNK, ROW_THREADS, 0,
                           stream>>>(
        static_cast<const bf16*>(Zs), gamma, beta, dh, static_cast<bf16*>(dz),
        static_cast<bf16*>(Hout), part, M, W);
    return (int)cudaGetLastError();
}

// Stage backward from the recomputed f32 z (K5); Hout may be null.
int k5_row_bwd(const float* Z, const float* gamma, const float* beta,
               const float* dh, void* dz, void* Hout, float* part, int M,
               int W, cudaStream_t stream) {
    if (W > ROW_THREADS * MAX_COLS_PER_THREAD) return (int)cudaErrorInvalidValue;
    row_bwd_kernel<float><<<(M + ROW_CHUNK - 1) / ROW_CHUNK, ROW_THREADS, 0,
                            stream>>>(
        Z, gamma, beta, dh, static_cast<bf16*>(dz), static_cast<bf16*>(Hout),
        part, M, W);
    return (int)cudaGetLastError();
}

int k3_colsum(const float* part, float* out, int nparts, long long ncols,
              cudaStream_t stream) {
    colsum_kernel<<<(unsigned)((ncols + 255) / 256), 256, 0, stream>>>(
        part, out, nparts, ncols);
    return (int)cudaGetLastError();
}

}  // extern "C"
