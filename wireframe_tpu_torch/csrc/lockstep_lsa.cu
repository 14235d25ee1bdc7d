// K4: batched rectangular Jonker-Volgenant assignment, hand-written for
// Hopper (sm_90a).
//
// Replaces wireframe_tpu/ops/pallas_lsa.py:solve_lsa_rows_pallas (body
// _lockstep_solve).  The TPU kernel runs every sample of the batch in
// lockstep under masks, because a TPU core has one instruction stream;
// each sample's solve is independent of the others, and the lockstep only
// freezes a sample whose loop has ended.  Here each sample gets its own
// block (one warp), so nothing is masked and a sample ends when its own
// loops end.
//
// Per sample, for row = 0 .. num_rows-1 (shortest augmenting path):
//   Dijkstra scan until the frontier minimum is an unassigned column:
//     reduced cost red[c] = ((minv + cost[i, c]) - u[i]) - v[c] relaxes the
//     unscanned columns; the frontier minimum `lowest` over unscanned
//     columns (NaN propagates, as jnp.min); among the columns at exactly
//     `lowest` the lowest-index UNASSIGNED one wins, else the lowest
//     index (pallas_lsa.py:103-113); j is clamped to C-1 (the NaN escape)
//     and the scan is bounded by k <= C;
//   the sink is clamped to >= 0; the dual update u, v;
//   augmentation along the predecessor path, bounded by k <= R.
// The arithmetic is the TPU kernel's, operation for operation, so for
// finite costs the assignment is equal element for element (the one-hot
// reductions of the TPU body equal these direct reads when every cost is
// finite; the wireframe loss clamps NaN and huge costs before the solve).
//
// What bounds it on this card: neither bytes nor FLOPs but the sequential
// chain: at most R * (C + 1) scan steps per sample, each a C-wide
// min-reduction (warp shuffles) whose result picks the next row.  One warp
// per sample keeps every reduction inside the warp (no __syncthreads) and
// the whole problem in shared memory: the cost matrix (6.4 KB at 40 x 40)
// plus u, v, the shortest-path costs, the predecessor path and the two
// assignment maps.  The optional `steps` output counts the scan steps this
// input needed, so a bound can be computed from the work done.
//
// Interface: plain C, loaded with ctypes; launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;   // one warp per sample

__device__ __forceinline__ float nan_min(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fminf(a, b);
}

__device__ __forceinline__ float warp_nan_min(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__global__ void __launch_bounds__(THREADS)
lsa_kernel(const float* __restrict__ cost, const int* __restrict__ num_rows,
           int* __restrict__ col4row, int* __restrict__ steps, int R, int C) {
    extern __shared__ float smem[];
    float* sc = smem;                         // (R, C) cost
    float* v = sc + (size_t)R * C;            // (C,) column duals
    float* spc = v + C;                       // (C,) shortest-path costs
    int* path = reinterpret_cast<int*>(spc + C);   // (C,) predecessor row
    int* r4c = path + C;                      // (C,) row of each column
    int* scanned = r4c + C;                   // (C,) SC
    float* u = reinterpret_cast<float*>(scanned + C);  // (R,) row duals
    int* c4r = reinterpret_cast<int*>(u + R);          // (R,) col of each row
    int* in_tree = c4r + R;                            // (R,) SR

    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const float* cb = cost + (size_t)b * R * C;
    for (int e = lane; e < R * C; e += THREADS) sc[e] = cb[e];
    for (int c = lane; c < C; c += THREADS) {
        v[c] = 0.0f;
        r4c[c] = -1;
    }
    for (int r = lane; r < R; r += THREADS) {
        u[r] = 0.0f;
        c4r[r] = -1;
    }
    __syncwarp();
    const int nr = min(max(num_rows[b], 0), R);
    int total_steps = 0;

    for (int row = 0; row < nr; ++row) {
        // ---- Dijkstra scan.
        for (int c = lane; c < C; c += THREADS) {
            scanned[c] = 0;
            spc[c] = INFINITY;
            path[c] = -1;
        }
        for (int r = lane; r < R; r += THREADS) in_tree[r] = 0;
        __syncwarp();
        float minv = 0.0f;
        int i = row, sink = -1, k = 0;
        while (sink < 0 && k <= C) {
            if (lane == 0) in_tree[i] = 1;
            const float u_i = u[i];
            const float* ci = sc + (size_t)i * C;
            float low = INFINITY;
            for (int c = lane; c < C; c += THREADS) {
                if (!scanned[c]) {
                    const float red = ((minv + ci[c]) - u_i) - v[c];
                    if (red < spc[c]) {
                        spc[c] = red;
                        path[c] = i;
                    }
                    low = nan_min(low, spc[c]);
                }
            }
            const float lowest = warp_nan_min(low);
            int j_un = C, j_any = C;
            for (int c = lane; c < C; c += THREADS) {
                const float cand = scanned[c] ? INFINITY : spc[c];
                if (cand == lowest) {
                    j_any = min(j_any, c);
                    if (r4c[c] == -1) j_un = min(j_un, c);
                }
            }
            j_un = warp_min(j_un);
            j_any = warp_min(j_any);
            int j = j_un < C ? j_un : j_any;
            j = min(j, C - 1);
            const int r4c_j = r4c[j];
            __syncwarp();
            if (r4c_j == -1) sink = j;
            else i = r4c_j;
            if (lane == 0) scanned[j] = 1;
            minv = lowest;
            ++k;
            __syncwarp();
        }
        total_steps += k;
        sink = max(sink, 0);

        // ---- Dual update (keeps later reduced costs non-negative).
        for (int r = lane; r < R; r += THREADS) {
            if (r == row) u[r] = u[r] + minv;
            else if (in_tree[r]) u[r] = (u[r] + minv) - spc[max(c4r[r], 0)];
        }
        for (int c = lane; c < C; c += THREADS)
            if (scanned[c]) v[c] = v[c] - (minv - spc[c]);
        __syncwarp();

        // ---- Augment along predecessors from the sink back to `row`.
        if (lane == 0) {
            int jj = sink;
            bool done = false;
            for (int ka = 0; !done && ka <= R; ++ka) {
                const int i_p = path[jj];
                const int safe_i = max(i_p, 0);
                r4c[jj] = safe_i;
                const int nxt = c4r[safe_i];
                c4r[safe_i] = jj;
                jj = nxt;
                done = i_p == row;
            }
        }
        __syncwarp();
    }
    for (int r = lane; r < R; r += THREADS)
        col4row[(size_t)b * R + r] = c4r[r];
    if (steps != nullptr && lane == 0) steps[b] = total_steps;
}

}  // namespace

extern "C" {

size_t k4_smem_bytes(int R, int C) {
    return (size_t)R * C * 4 + (size_t)C * 4 * 5 + (size_t)R * 4 * 3;
}

int k4_lsa(const float* cost, const int* num_rows, int* col4row, int* steps,
           int B, int R, int C, cudaStream_t stream) {
    const size_t smem = k4_smem_bytes(R, C);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lsa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (B == 0) return 0;
    lsa_kernel<<<B, THREADS, smem, stream>>>(cost, num_rows, col4row, steps,
                                             R, C);
    return (int)cudaGetLastError();
}

}  // extern "C"
