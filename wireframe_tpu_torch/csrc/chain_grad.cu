// K2 + K3 + K5: the differentiable point chain of the training step,
// hand-written for Hopper (sm_90a).
//
// Replaces wireframe_tpu/ops/pallas_chain_grad.py:
//   K2 _chain_forward_stash_pallas (forward, stashing the pre-LayerNorm
//      activations z_k in the compute dtype, with the kv window max /
//      argmax / masked window sum of _kv_pool_tile_fwd);
//   K3 _chain_backward_pallas with zs (backward from the stash: the kv
//      cotangent scatter of _kv_pool_tile_bwd, LayerNorm statistics
//      rebuilt from the stored z (_stages_from_z), then per stage the ReLU
//      backward with jnp.maximum's tie rule, the LayerNorm backward,
//      dW = h^T dz and dh = dz W^T; f32 parameter gradients);
//   K5 _chain_forward_pallas (the same forward without the stash) and
//      _chain_backward_pallas with zs=None (_recompute_stages: each
//      stage's z recomputed by the forward's own kernel, so z and h are
//      bit-identical to the forward's, the statistics taken from the f32
//      z; then K3's stage backward on the f32 z).
// Each in the JAX kernels' two compute dtypes: bf16 operands (the
// functions below) and f32 operands (the `_f32` functions: f32 h, stash
// and dz, 3xTF32 main loop; see hopper_gemm.cuh), f32 accumulation in
// both.
//
// What bounds it on this card: operations.  The forward is the same
// 10.49 MFLOP per point as K1, K3 twice that (dW and dh) and K5's
// backward three times (recompute, dW, dh), while the stash is 2 B per
// activation (189 MB at B=8, N=2560): ~0.06 ms at 3.35 TB/s against
// ~0.22 ms of bf16 tensor-core time for the forward.  In f32 the stash
// doubles (377.5 MB, ~0.11 ms) and the forward's operations take ~1.3 ms
// as three TF32 products each (494.7 / 3 TFLOP/s).
//
// Design: every product goes through the wgmma + TMA GEMM of
// hopper_gemm.cuh, which keeps what the Pallas kernel keeps in VMEM out
// of device memory too:
//   - k2_gemm_ln: a stage's z = h W + b with its LayerNorm + ReLU fused
//     into the epilogue across a cluster of ceil(W / 256) CTAs: f32 z is
//     never written in bf16; h and the stash (K2: bf16 z, or in f32 the
//     f32 z itself), the f32 z (K5's recompute) or nothing (K5's forward)
//     are;
//   - k3_gemm_ln_bwd: a stage's dh = dz_above W_above^T with the stage's
//     LayerNorm / ReLU backward fused into the epilogue (statistics from
//     the stash, K3, or the f32 z, K5): f32 dh is never written; dz, the
//     rebuilt h (K3) and per-row-tile column partials of d gamma, d beta,
//     d b are;
//   - a stage wider than a cluster (W > 8 x 256) runs split instead: z
//     (forward) or dh (backward) goes through k23_gemm's STORE epilogue to
//     device memory in f32, and layernorm_rows.cu's row kernels do the
//     LayerNorm, forward or backward, with the same outputs;
//   - k23_gemm: the plain products: the projection (+ bias), dx = dz W0^T
//     and dW = h^T dz (split over the rows, per-slice partials);
//   - k23_prep_x: x in the compute dtype (as x.astype(cdt)) with a padded
//     row stride, and the rows' validity (hgemm::prep_x, shared with K1);
//   - k2_window_pool: one thread per (window, channel): masked max with
//     the lowest tied offset as argmax (0 for an all-invalid window, as
//     jnp.argmax over all -inf gives 0) and the masked window sum;
//   - k3_seed: the kv cotangent scatter (+ the feature cotangent when the
//     flavour has one) -> the cotangent in the compute dtype and
//     per-block column partials of d final_b;
//   - k3_colsum: sums per-block (or per-K-slice) partials in block order;
//     k3_colsum_acc carries such a sum on from an earlier call.
// No float atomics anywhere: gradients repeat bit for bit run to run.
// K5's backward recomputes chunk by chunk of rows (ops/chain_grad.py's
// remat_plan): a chunk's f32 z and h live only while that chunk's stage
// backward runs, as the Pallas kernel's live only in one tile's VMEM.
// The LayerNorm / bias partials of every chunk's row tiles go through
// k3_colsum_acc in tile order, so they sum to the same bits as in one
// chunk; each chunk's dW K-slices are added on in slice order after the
// earlier chunks'.
//
// Interface: plain C, loaded with ctypes.  Every function launches on the
// stream it is given, allocates nothing, and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int ROW_THREADS = 256;
constexpr int ROW_CHUNK = 32;          // rows per k3_seed block
constexpr int MAX_COLS_PER_THREAD = 8; // 2048 columns per k3_seed block
constexpr int POOL_THREADS = 128;

// Masked window pool of the features F (B*N, C) over windows of p
// consecutive rows (windows never straddle clouds: N % p == 0).
// grid (windows, ceil(C / POOL_THREADS)): the windows go on x, whose
// limit is 2^31 - 1 (y's is 65535, fewer than the 81920 windows of a
// (128, 2560) batch at p = 4).
__global__ void window_pool_kernel(const float* __restrict__ F,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ pooled,
                                   int* __restrict__ idx,
                                   float* __restrict__ sums, int C, int p) {
    const int w = blockIdx.x;
    const int c = blockIdx.y * POOL_THREADS + threadIdx.x;
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
// Written in the compute dtype T (row stride ldg) for both GEMMs; block
// column partials of the f32 sum for d final_b.  One block per ROW_CHUNK
// rows and ROW_THREADS * MAX_COLS_PER_THREAD columns (blockIdx.y).
template <typename T>
__global__ void seed_kernel(const float* __restrict__ dpool,
                            const int* __restrict__ idx,
                            const float* __restrict__ dsums,
                            const uint8_t* __restrict__ valid,
                            const float* __restrict__ gfeat,
                            T* __restrict__ gbf, int ldg,
                            float* __restrict__ part, int M, int C, int p) {
    const int r0 = blockIdx.x * ROW_CHUNK;
    const int r1 = min(M, r0 + ROW_CHUNK);
    const int cbase = blockIdx.y * ROW_THREADS * MAX_COLS_PER_THREAD;
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
            const int c = cbase + threadIdx.x + j * ROW_THREADS;
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
            hgemm::put(gbf + (size_t)r * ldg + c, g);
        }
    }
#pragma unroll
    for (int j = 0; j < MAX_COLS_PER_THREAD; ++j) {
        const int c = cbase + threadIdx.x + j * ROW_THREADS;
        if (c < C) part[(size_t)blockIdx.x * C + c] = acc[j];
    }
}

// out[c] = sum over b < nparts, in order, of part[b * ncols + c]; with
// ACC the sum starts from out[c] instead of 0, so that partials that
// arrive in several calls (K5's row chunks) are summed in the same order,
// and to the same bits, as in one call.
template <bool ACC>
__global__ void colsum_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int nparts,
                              long long ncols) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= ncols) return;
    float s = ACC ? out[c] : 0.0f;
    for (int b = 0; b < nparts; ++b) s += part[(long long)b * ncols + c];
    out[c] = s;
}

// k3_seed in the compute dtype T.
template <typename T>
int seed(const float* dpool, const int* idx, const float* dsums,
         const uint8_t* valid, const float* gfeat, void* g, int ldg,
         float* part, int M, int C, int p, cudaStream_t stream) {
    constexpr int COLS = ROW_THREADS * MAX_COLS_PER_THREAD;
    if (C < 1 || ldg < C) return (int)cudaErrorInvalidValue;
    seed_kernel<T><<<dim3((M + ROW_CHUNK - 1) / ROW_CHUNK,
                          (C + COLS - 1) / COLS),
                     ROW_THREADS, 0, stream>>>(dpool, idx, dsums, valid,
                                               gfeat, static_cast<T*>(g),
                                               ldg, part, M, C, p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The GEMM tile (which: 0 rows, 1 columns, 2 depth) of the bf16 and of
// the f32 main loop, the shared memory a GEMM launch takes, the widest
// stage a cluster covers (a wider one runs split), and the rows per
// k3_seed block, for the caller's plan.
int k23_tile(int which) {
    return which == 0 ? hgemm::BM : (which == 1 ? hgemm::BN : hgemm::BK);
}
int k23_tile_f32(int which) {
    return which == 0 ? hgemm::BM : (which == 1 ? hgemm::BN : hgemm::BK_F32);
}
int k23_smem_bytes() { return hgemm::SMEM_BYTES; }
int k23_max_fused_width() { return hgemm::MAX_CLUSTER * hgemm::BN; }
int k23_row_chunk() { return ROW_CHUNK; }

// Each function below has an `_f32` twin with the same arguments whose
// operands, h, dz and seed are f32 (and whose stash is the f32 z).

int k23_prep_x(const float* X, int D, void* xb, int ldx, uint8_t* valid,
               int M, cudaStream_t stream) {
    return hgemm::prep_x(X, D, static_cast<bf16*>(xb), ldx, valid, M, stream);
}
int k23_prep_x_f32(const float* X, int D, void* xb, int ldx, uint8_t* valid,
                   int M, cudaStream_t stream) {
    return hgemm::prep_x(X, D, static_cast<float*>(xb), ldx, valid, M,
                         stream);
}

// C = op(A) @ op(B) (+ bias); form 0: A B (B stored (K, N)), 1: A B^T
// (B stored (N, K)), 2: A^T B (A stored (K, M)), `splits` K-slices of
// ksplit rows each writing partials at C + s * M * ldc.
int k23_gemm(int form, const void* A, int lda, const void* B, int ldb,
             const float* bias, float* C, int ldc, int M, int N, int K,
             int splits, int ksplit, cudaStream_t stream) {
    return hgemm::gemm_store(form, A, lda, B, ldb, bias, C, ldc, M, N, K,
                             splits, ksplit, false, stream);
}
int k23_gemm_f32(int form, const void* A, int lda, const void* B, int ldb,
                 const float* bias, float* C, int ldc, int M, int N, int K,
                 int splits, int ksplit, cudaStream_t stream) {
    return hgemm::gemm_store(form, A, lda, B, ldb, bias, C, ldc, M, N, K,
                             splits, ksplit, true, stream);
}

// One forward stage (K2; K5's forward with Z null, K5's recompute with
// the f32 z): see hgemm::gemm_ln_fwd.  In f32, z_f32 must be 1 for a Z.
int k2_gemm_ln(const void* A, int lda, const void* W, int ldw,
               const float* bias, const float* gamma, const float* beta,
               void* H, int ldh, void* Z, int ldz, int z_f32, int M, int N,
               int K, cudaStream_t stream) {
    return hgemm::gemm_ln_fwd(A, lda, W, ldw, bias, gamma, beta, H, ldh, Z,
                              ldz, z_f32, M, N, K, false, stream);
}
int k2_gemm_ln_f32(const void* A, int lda, const void* W, int ldw,
                   const float* bias, const float* gamma, const float* beta,
                   void* H, int ldh, void* Z, int ldz, int z_f32, int M,
                   int N, int K, cudaStream_t stream) {
    return hgemm::gemm_ln_fwd(A, lda, W, ldw, bias, gamma, beta, H, ldh, Z,
                              ldz, z_f32, M, N, K, true, stream);
}

// One stage's backward (K3 from the stash; K5 from the recomputed f32 z
// with a null Hout): see hgemm::gemm_ln_bwd.  In f32, z_f32 must be 1.
int k3_gemm_ln_bwd(const void* A, int lda, const void* W, int ldw,
                   const void* Z, int ldz, int z_f32, const float* gamma,
                   const float* beta, void* DZ, int lddz, void* Hout,
                   int ldh, float* part, int M, int N, int K,
                   cudaStream_t stream) {
    return hgemm::gemm_ln_bwd(A, lda, W, ldw, Z, ldz, z_f32, gamma, beta, DZ,
                              lddz, Hout, ldh, part, M, N, K, false, stream);
}
int k3_gemm_ln_bwd_f32(const void* A, int lda, const void* W, int ldw,
                       const void* Z, int ldz, int z_f32, const float* gamma,
                       const float* beta, void* DZ, int lddz, void* Hout,
                       int ldh, float* part, int M, int N, int K,
                       cudaStream_t stream) {
    return hgemm::gemm_ln_bwd(A, lda, W, ldw, Z, ldz, z_f32, gamma, beta, DZ,
                              lddz, Hout, ldh, part, M, N, K, true, stream);
}

int k2_window_pool(const float* F, const uint8_t* valid, float* pooled,
                   int* idx, float* sums, int windows, int C, int p,
                   cudaStream_t stream) {
    window_pool_kernel<<<dim3(windows, (C + POOL_THREADS - 1) / POOL_THREADS),
                         POOL_THREADS, 0, stream>>>(F, valid, pooled, idx,
                                                    sums, C, p);
    return (int)cudaGetLastError();
}

int k3_seed(const float* dpool, const int* idx, const float* dsums,
            const uint8_t* valid, const float* gfeat, void* gbf, int ldg,
            float* part, int M, int C, int p, cudaStream_t stream) {
    return seed<bf16>(dpool, idx, dsums, valid, gfeat, gbf, ldg, part, M, C,
                      p, stream);
}
int k3_seed_f32(const float* dpool, const int* idx, const float* dsums,
                const uint8_t* valid, const float* gfeat, void* g, int ldg,
                float* part, int M, int C, int p, cudaStream_t stream) {
    return seed<float>(dpool, idx, dsums, valid, gfeat, g, ldg, part, M, C,
                       p, stream);
}

int k3_colsum(const float* part, float* out, int nparts, long long ncols,
              cudaStream_t stream) {
    colsum_kernel<false><<<(unsigned)((ncols + 255) / 256), 256, 0,
                           stream>>>(part, out, nparts, ncols);
    return (int)cudaGetLastError();
}

// out[c] += the partials, in order, after out[c]: K5's later row chunks.
int k3_colsum_acc(const float* part, float* out, int nparts,
                  long long ncols, cudaStream_t stream) {
    colsum_kernel<true><<<(unsigned)((ncols + 255) / 256), 256, 0,
                          stream>>>(part, out, nparts, ncols);
    return (int)cudaGetLastError();
}

}  // extern "C"
