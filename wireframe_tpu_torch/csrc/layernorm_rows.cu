// The LayerNorm + ReLU of an encoder-chain stage too wide for one
// thread-block cluster (more than 8 x 256 columns), forward and backward,
// hand-written for Hopper (sm_90a).
//
// Part of the port of wireframe_tpu/ops/pallas_encoder.py
// (fused_point_encoder, K1) and wireframe_tpu/ops/pallas_chain_grad.py
// (_chain_forward_stash_pallas K2, _chain_backward_pallas K3 and K5,
// _chain_forward_pallas K5): their per-stage `_ln` + ReLU and its
// backward (`_stages_from_z` / `_recompute_stages`, jnp.maximum's tie
// rule).  A stage of width W <= 2048 keeps its LayerNorm in the epilogue
// of its GEMM (hopper_gemm.cuh, LN_FWD / LN_BWD across a cluster of
// ceil(W / 256) CTAs).  A wider stage runs split: its GEMM writes the f32
// product with the STORE epilogue (z = h W + b forward, dh = dz_above
// W_above^T backward) and the kernels here do the rest, reading that f32
// array from device memory:
//   ln_fwd_rows_kernel   one warp a row: the mean, then the centred
//                        variance (two passes, eps 1e-6), each lane summing
//                        its columns lane + 32 k in order and the warp by an
//                        xor butterfly (every lane gets the same bits); then
//                        h = relu(ln) in the operand type from the f32 z,
//                        and the bf16 stash of z when asked (K2 in bf16; in
//                        f32 the stash is the f32 z itself);
//   ln_bwd_stats_kernel  one warp a row: the statistics rebuilt from the z
//                        the fused LN_BWD reads (the bf16 stash, K3 in bf16;
//                        the f32 z, K3 in f32 and K5), then the row means of
//                        dxhat and dxhat * xhat, with dln = dh where ln > 0,
//                        0 where ln < 0 and dh / 2 where ln == 0; (mean,
//                        rstd, m1, m2) per row;
//   ln_bwd_cols_kernel   one thread a column of a 128-row tile, its rows in
//                        order: dz = (dxhat - m1 - xhat m2) rstd and the
//                        rebuilt h (K3) in the operand type, and the tile's
//                        column partials of d gamma, d beta and d b, which
//                        the caller sums over the tiles in order
//                        (chain_grad.cu's k3_colsum), as it does the fused
//                        epilogue's.
// No float atomics: two launches give the same bits.
//
// What bounds them on this card: bytes.  Per element the forward reads
// the f32 z and writes h (and the stash): 8 B in bf16, 8 B in f32; the
// backward reads z and the f32 dh and writes dz (and h): 10 to 16 B.  At
// (20480, 4096) that is 0.2 to 0.4 ms at 3.35 TB/s.  A row of a few
// thousand floats stays in L1 between a warp's passes, so device memory
// sees about one read of each input.
//
// Interface: plain C, loaded with ctypes.  Every function launches on the
// stream it is given, allocates nothing, and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int ROW_WARPS = 8;          // rows per block (one warp each)
constexpr int COL_THREADS = 256;      // columns per block of the cols kernel
constexpr int ROW_TILE = 128;         // rows of a partial (the GEMM's BM)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float get(const float* p) { return *p; }
__device__ __forceinline__ float get(const bf16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void put(bf16* p, float v) {
    *p = __float2bfloat16(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// Mean and rstd of row z (n elements), as the fused epilogues take them.
template <typename ZT>
__device__ __forceinline__ void row_stats(const ZT* z, int n, int lane,
                                          float& mu, float& rstd) {
    float s = 0.0f;
#pragma unroll 4
    for (int c = lane; c < n; c += 32) s += get(z + c);
    mu = warp_sum(s) / (float)n;
    float v = 0.0f;
#pragma unroll 4
    for (int c = lane; c < n; c += 32) {
        const float d = get(z + c) - mu;
        v += d * d;
    }
    rstd = rsqrtf(warp_sum(v) / (float)n + 1e-6f);
}

// H = relu(LayerNorm(Z)) in T; S (bf16, null: none) = Z rounded.
template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_fwd_rows_kernel(const float* __restrict__ Z, int ldz,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ H,
                   int ldh, bf16* __restrict__ S, int lds, int M, int N) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (row >= M) return;
    const float* z = Z + (size_t)row * ldz;
    float mu, rstd;
    row_stats(z, N, lane, mu, rstd);
    T* h = H + (size_t)row * ldh;
    bf16* s = S == nullptr ? nullptr : S + (size_t)row * lds;
#pragma unroll 4
    for (int c = lane; c < N; c += 32) {
        const float zc = z[c];
        put(h + c, fmaxf((zc - mu) * rstd * gamma[c] + beta[c], 0.0f));
        if (s != nullptr) s[c] = __float2bfloat16(zc);
    }
}

// dln of the ReLU with jnp.maximum's tie rule.
__device__ __forceinline__ float relu_grad(float ln, float g) {
    return ln > 0.0f ? g : (ln < 0.0f ? 0.0f : 0.5f * g);
}

// stats[row] = (mean, rstd, mean(dxhat), mean(dxhat * xhat)).
template <typename ZT>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_bwd_stats_kernel(const ZT* __restrict__ Z, int ldz,
                    const float* __restrict__ DH, int lddh,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    float4* __restrict__ stats, int M, int N) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (row >= M) return;
    const ZT* z = Z + (size_t)row * ldz;
    const float* dh = DH + (size_t)row * lddh;
    float mu, rstd;
    row_stats(z, N, lane, mu, rstd);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
    for (int c = lane; c < N; c += 32) {
        const float xhat = (get(z + c) - mu) * rstd;
        const float g = gamma[c];
        const float dxhat = relu_grad(xhat * g + beta[c], dh[c]) * g;
        s1 += dxhat;
        s2 += dxhat * xhat;
    }
    const float inv_n = 1.0f / (float)N;
    s1 = warp_sum(s1) * inv_n;
    s2 = warp_sum(s2) * inv_n;
    if (lane == 0) stats[row] = make_float4(mu, rstd, s1, s2);
}

// DZ and (H not null) the rebuilt h in T; part[tile][d gamma | d beta |
// d b][N].
template <typename T, typename ZT>
__global__ void __launch_bounds__(COL_THREADS)
ln_bwd_cols_kernel(const ZT* __restrict__ Z, int ldz,
                   const float* __restrict__ DH, int lddh,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const float4* __restrict__ stats, T* __restrict__ DZ,
                   int lddz, T* __restrict__ H, int ldh,
                   float* __restrict__ part, int M, int N) {
    const int c = blockIdx.x * COL_THREADS + threadIdx.x;
    if (c >= N) return;
    const int r0 = blockIdx.y * ROW_TILE;
    const int r1 = min(M, r0 + ROW_TILE);
    const float g = gamma[c], be = beta[c];
    float cg = 0.0f, cb = 0.0f, cz = 0.0f;
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
        const float4 st = stats[r];
        const float xhat = (get(Z + (size_t)r * ldz + c) - st.x) * st.y;
        const float ln = xhat * g + be;
        const float dln = relu_grad(ln, DH[(size_t)r * lddh + c]);
        const float dz = (dln * g - st.z - xhat * st.w) * st.y;
        put(DZ + (size_t)r * lddz + c, dz);
        if (H != nullptr) put(H + (size_t)r * ldh + c, fmaxf(ln, 0.0f));
        cg += dln * xhat;
        cb += dln;
        cz += dz;
    }
    float* out = part + (size_t)blockIdx.y * 3 * N + c;
    out[0] = cg;
    out[N] = cb;
    out[2 * N] = cz;
}

template <typename T>
int fwd(const float* Z, int ldz, const float* gamma, const float* beta,
        void* H, int ldh, void* S, int lds, int M, int N,
        cudaStream_t stream) {
    if (M < 1 || N < 1 || ldz < N || ldh < N || (S != nullptr && lds < N))
        return (int)cudaErrorInvalidValue;
    ln_fwd_rows_kernel<T><<<(M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32,
                            0, stream>>>(Z, ldz, gamma, beta,
                                         static_cast<T*>(H), ldh,
                                         static_cast<bf16*>(S), lds, M, N);
    return (int)cudaGetLastError();
}

template <typename T, typename ZT>
int bwd(const void* Z, int ldz, const float* DH, int lddh,
        const float* gamma, const float* beta, float* stats, void* DZ,
        int lddz, void* H, int ldh, float* part, int M, int N,
        cudaStream_t stream) {
    if (M < 1 || N < 1 || ldz < N || lddh < N || lddz < N ||
        (H != nullptr && ldh < N) || reinterpret_cast<uintptr_t>(stats) % 16)
        return (int)cudaErrorInvalidValue;
    const ZT* z = static_cast<const ZT*>(Z);
    float4* st = reinterpret_cast<float4*>(stats);
    ln_bwd_stats_kernel<ZT><<<(M + ROW_WARPS - 1) / ROW_WARPS,
                              ROW_WARPS * 32, 0, stream>>>(
        z, ldz, DH, lddh, gamma, beta, st, M, N);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ln_bwd_cols_kernel<T, ZT><<<dim3((N + COL_THREADS - 1) / COL_THREADS,
                                     (M + ROW_TILE - 1) / ROW_TILE),
                                COL_THREADS, 0, stream>>>(
        z, ldz, DH, lddh, gamma, beta, st, static_cast<T*>(DZ), lddz,
        static_cast<T*>(H), ldh, part, M, N);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The rows of one backward partial, for the caller's plan.
int ln_rows_tile() { return ROW_TILE; }

// Forward: H = relu(LayerNorm(Z)) (Z f32 (M, N), row stride ldz) in bf16
// (ln_rows_fwd) or f32 (ln_rows_fwd_f32); S, when not null, the bf16
// stash of Z (bf16 only).
int ln_rows_fwd(const float* Z, int ldz, const float* gamma,
                const float* beta, void* H, int ldh, void* S, int lds, int M,
                int N, cudaStream_t stream) {
    return fwd<bf16>(Z, ldz, gamma, beta, H, ldh, S, lds, M, N, stream);
}
int ln_rows_fwd_f32(const float* Z, int ldz, const float* gamma,
                    const float* beta, void* H, int ldh, void* S, int lds,
                    int M, int N, cudaStream_t stream) {
    if (S != nullptr) return (int)cudaErrorInvalidValue;
    return fwd<float>(Z, ldz, gamma, beta, H, ldh, nullptr, 0, M, N, stream);
}

// Backward from dh (f32 (M, N), row stride lddh) and the stage's z: the
// bf16 stash (z_f32 = 0) or the f32 z (z_f32 = 1; the only z in f32).
// DZ and H (the rebuilt h; null: not written) in bf16 (ln_rows_bwd) or
// f32 (ln_rows_bwd_f32); stats: an (M, 4) f32 scratch, 16-byte aligned;
// part: (ceil(M / 128), 3 N) f32.
int ln_rows_bwd(const void* Z, int ldz, int z_f32, const float* DH, int lddh,
                const float* gamma, const float* beta, float* stats,
                void* DZ, int lddz, void* H, int ldh, float* part, int M,
                int N, cudaStream_t stream) {
    return z_f32 ? bwd<bf16, float>(Z, ldz, DH, lddh, gamma, beta, stats, DZ,
                                    lddz, H, ldh, part, M, N, stream)
                 : bwd<bf16, bf16>(Z, ldz, DH, lddh, gamma, beta, stats, DZ,
                                   lddz, H, ldh, part, M, N, stream);
}
int ln_rows_bwd_f32(const void* Z, int ldz, int z_f32, const float* DH,
                    int lddh, const float* gamma, const float* beta,
                    float* stats, void* DZ, int lddz, void* H, int ldh,
                    float* part, int M, int N, cudaStream_t stream) {
    if (!z_f32) return (int)cudaErrorInvalidValue;
    return bwd<float, float>(Z, ldz, DH, lddh, gamma, beta, stats, DZ, lddz,
                             H, ldh, part, M, N, stream);
}

}  // extern "C"
