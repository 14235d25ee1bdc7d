// Tiled WMMA GEMM of K1 (fused_encoder.cu), hand-written for Hopper
// (sm_90a).  The chain kernels K2 / K3 / K5 use hopper_gemm.cuh instead.
//
//   C (M, N) f32 = A (M, K) @ B (K, N) + bias (N,)
//
// bf16 operands staged through shared memory, nvcuda::wmma 16x16x16 bf16
// tiles with f32 accumulators, 128x128x32 block tiles, two shared-memory
// stages fed by register prefetch.  A is an (M, K) row-major array, f32
// (rounded to bf16 on load exactly as `x.astype(bf16)`) or bf16; B is a
// (K, N) row-major bf16 array (a weight (in, out)).  The ragged M / N / K
// edges are masked on load (zero fill) and on store.
//
// What bounds it: operations (2*M*N*K against a few bytes per output at
// K1's shapes); its times against that bound are in PERF.md.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace wgemm {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;              // 8 warps: 2 (rows) x 4 (cols)
constexpr int WARP_M = 64;                // each warp: 64 x 32 outputs
constexpr int WARP_N = 32;
constexpr int FRAG_M = WARP_M / 16;       // 4
constexpr int FRAG_N = WARP_N / 16;       // 2
// Padded leading dims (bf16) of the shared tiles.
constexpr int A_LD = BK + 8;              // row-major A tile [BM][BK]
constexpr int B_LD = BN + 8;              // row-major B tile [BK][BN]

__device__ __forceinline__ uint4 pack8(const float* v) {
    uint4 out;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return out;
}

// 8 consecutive elements (row, col..col+7) of a row-major array with
// leading dim `ld`, as bf16; zero outside rows < nrows, cols < ncols.
__device__ __forceinline__ uint4 load8(const bf16* P, int ld, int nrows,
                                       int ncols, int row, int col) {
    if (row < nrows && col + 8 <= ncols && (ld & 7) == 0)
        return *reinterpret_cast<const uint4*>(P + (size_t)row * ld + col);
    uint4 out;
    bf16* p = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int e = 0; e < 8; ++e)
        p[e] = (row < nrows && col + e < ncols) ? P[(size_t)row * ld + col + e]
                                                : __float2bfloat16(0.0f);
    return out;
}

__device__ __forceinline__ uint4 load8(const float* P, int ld, int nrows,
                                       int ncols, int row, int col) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
        v[e] = (row < nrows && col + e < ncols) ? P[(size_t)row * ld + col + e]
                                                : 0.0f;
    return pack8(v);
}

// Two blocks per SM: at most 128 registers a thread (one register more
// halves the blocks an SM holds, and costs K1 ~25% at its shapes).
template <typename TA>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const TA* __restrict__ A, const bf16* __restrict__ B,
            const float* __restrict__ bias, float* __restrict__ C,
            int M, int N, int K) {
    __shared__ __align__(128) bf16 sA[2][BM * A_LD];
    __shared__ __align__(128) bf16 sB[2][BK * B_LD];
    __shared__ __align__(128) float sOut[THREADS / 32][16 * 16];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int wm = warp >> 2;             // 0..1
    const int wn = warp & 3;              // 0..3
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int kbeg = 0;
    const int kend = K;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAG_M][FRAG_N];
#pragma unroll
    for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
        for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // Each thread moves 2 vectors of 8 bf16 for A (128 x 32) and for
    // B (32 x 128) per k-tile.
    uint4 ra[2], rb[2];
    auto load_regs = [&](int k0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int v = tid + i * THREADS;
            // A: 128 m-rows of 32 k; B: 32 k-rows of 128 n.
            ra[i] = load8(A, K, M, kend, m0 + v / (BK / 8),
                          k0 + (v % (BK / 8)) * 8);
            rb[i] = load8(B, N, kend, N, k0 + v / (BN / 8),
                          n0 + (v % (BN / 8)) * 8);
        }
    };
    auto store_smem = [&](int buf) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int v = tid + i * THREADS;
            bf16* a = &sA[buf][(v / (BK / 8)) * A_LD + (v % (BK / 8)) * 8];
            bf16* b = &sB[buf][(v / (BN / 8)) * B_LD + (v % (BN / 8)) * 8];
            *reinterpret_cast<uint4*>(a) = ra[i];
            *reinterpret_cast<uint4*>(b) = rb[i];
        }
    };

    const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
    if (nk > 0) {
        load_regs(kbeg);
        store_smem(0);
    }
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
        const int cur = kt & 1;
        if (kt + 1 < nk) load_regs(kbeg + (kt + 1) * BK);  // loads in flight
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                           wmma::row_major> fa[FRAG_M];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                           wmma::row_major> fb[FRAG_N];
#pragma unroll
            for (int i = 0; i < FRAG_M; ++i) {
                const int r = wm * WARP_M + i * 16;
                wmma::load_matrix_sync(fa[i], &sA[cur][r * A_LD + kk], A_LD);
            }
#pragma unroll
            for (int j = 0; j < FRAG_N; ++j) {
                const int c = wn * WARP_N + j * 16;
                wmma::load_matrix_sync(fb[j], &sB[cur][kk * B_LD + c], B_LD);
            }
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

// Launches C = A @ B + bias.
template <typename TA>
inline int launch_gemm(const TA* A, const bf16* B, const float* bias,
                       float* C, int M, int N, int K, cudaStream_t stream) {
    if (bias == nullptr) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<TA><<<grid, THREADS, 0, stream>>>(A, B, bias, C, M, N, K);
    return (int)cudaGetLastError();
}

}  // namespace wgemm
