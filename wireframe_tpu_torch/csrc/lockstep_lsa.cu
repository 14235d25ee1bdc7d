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
// The arithmetic is the TPU kernel's, operation for operation, so the
// assignment is equal element for element (non-finite costs included, see
// below; the wireframe loss clamps NaN and huge costs before the solve).
//
// What bounds it on this card: neither bytes nor FLOPs but the sequential
// chain: at most R * (C + 1) scan steps per sample, each a C-wide
// relax-and-min whose result picks the next row.  So the design cuts the
// latency of one scan step:
//   - one warp per sample, each lane owning columns lane + 32 k (k < CPL,
//     2 for C <= 64, 4 for C <= 128) with their spc, v, path, r4c and
//     scanned bit in registers;
//   - relax and choose in one pass, then one warp min over a packed 64-bit
//     key: the order-preserving bits of the candidate (-0.0 folded into
//     +0.0), an "assigned" flag, the column.  Its minimum is the column
//     the Pallas rule picks: the lowest value, among exact ties an
//     unassigned column first, then the lowest index; a NaN candidate
//     (jnp.min propagates it, and then no column equals it) keys as the
//     least value with column C - 1, the TPU body's clamp.  The min is
//     taken as two redux.sync steps (value bits, then flag + column among
//     the lanes holding the least value);
//   - r4c[j] comes by shuffle from the lane that owns j, which also marks
//     j scanned: no shared-memory round trip and no __syncwarp on the
//     scan's path.  Only the cost row (shared memory, read-only) and u[i]
//     are loads.
// The dual update and the augmentation run once per row through shared
// memory.
//
// The TPU body reads every dynamic index as a one-hot multiply-and-sum,
// where 0 * inf and 0 * NaN are NaN.  The kernel reproduces that, so it
// stays array_equal to the plain version for non-finite costs too: a cost
// reads as NaN when another row of its column is not finite (folded into
// the shared copy of the costs once), u[i] when another row's dual is not
// finite, spc at a row's column when another column's spc is not finite;
// an augmenting step from a column index off the matrix reads path 0 and
// writes no r4c.  The optional `steps` output counts the scan steps this
// input needed, so a bound can be computed from the work done.
//
// Interface: plain C, loaded with ctypes; launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;   // one warp per sample
constexpr unsigned FULL = 0xffffffffu;

// Order-preserving unsigned bits of a non-NaN float, -0.0 as +0.0; NaN
// takes 0, below every other value (ordered(-inf) = 0x007fffff).
__device__ __forceinline__ unsigned ordered(float x) {
    if (x != x) return 0u;
    const unsigned b = x == 0.0f ? 0u : __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
    if (o == 0u) return __uint_as_float(0x7fc00000u);
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// x as the one-hot sum reads it: NaN when x is NaN or when `bad` (the
// count of non-finite entries summed over, x included) counts another.
__device__ __forceinline__ float onehot_read(float x, int bad) {
    const int others = bad - (isfinite(x) ? 0 : 1);
    return (x != x || others > 0) ? __uint_as_float(0x7fc00000u) : x;
}

template <int CPL>
__global__ void __launch_bounds__(THREADS)
lsa_kernel(const float* __restrict__ cost, const int* __restrict__ num_rows,
           int* __restrict__ col4row, int* __restrict__ steps, int R, int C) {
    extern __shared__ float smem[];
    float* ce = smem;                              // (R, C) cost, one-hot read
    float* u = ce + (size_t)R * C;                 // (R,) row duals
    float* spc_s = u + R;                          // (C,) for the dual update
    int* path_s = reinterpret_cast<int*>(spc_s + C);   // (C,)
    int* r4c_s = path_s + C;                       // (C,) row of each column
    int* c4r = r4c_s + C;                          // (R,) column of each row

    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const float* cb = cost + (size_t)b * R * C;
    for (int c = lane; c < C; c += THREADS) {
        int bad = 0;
        for (int r = 0; r < R; ++r) bad += isfinite(cb[(size_t)r * C + c]) ? 0 : 1;
        for (int r = 0; r < R; ++r)
            ce[(size_t)r * C + c] = onehot_read(cb[(size_t)r * C + c], bad);
        r4c_s[c] = -1;
    }
    for (int r = lane; r < R; r += THREADS) {
        u[r] = 0.0f;
        c4r[r] = -1;
    }
    float v[CPL];
    int r4c[CPL];
#pragma unroll
    for (int s = 0; s < CPL; ++s) {
        v[s] = 0.0f;
        r4c[s] = -1;
    }
    __syncwarp();
    const int nr = min(max(num_rows[b], 0), R);
    int total_steps = 0;
    int ubad = 0;                   // non-finite entries of u

    for (int row = 0; row < nr; ++row) {
        // ---- Dijkstra scan, column state in registers.
        float spc[CPL];
        int path[CPL];
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
            spc[s] = INFINITY;
            path[s] = -1;
        }
        unsigned scanned = 0u, tree = 0u;   // bit s: column / row lane + 32 s
        float minv = 0.0f;
        int i = row, sink = -1, k = 0;
        while (sink < 0 && k <= C) {
            if ((i & 31) == lane) tree |= 1u << (i >> 5);
            const float u_i = onehot_read(u[i], ubad);
            const float* ci = ce + (size_t)i * C;
            unsigned hi = 0xffffffffu, lo = 0xffffffffu;
#pragma unroll
            for (int s = 0; s < CPL; ++s) {
                const int c = lane + 32 * s;
                if (c < C) {
                    const bool done = (scanned >> s) & 1u;
                    if (!done) {
                        const float red = ((minv + ci[c]) - u_i) - v[s];
                        if (red < spc[s]) {
                            spc[s] = red;
                            path[s] = i;
                        }
                    }
                    const float cand = done ? INFINITY : spc[s];
                    const unsigned kh = ordered(cand);
                    const unsigned kl = cand != cand
                        ? (unsigned)(C - 1)
                        : ((r4c[s] != -1 ? 0x10000u : 0u) | (unsigned)c);
                    if (kh < hi || (kh == hi && kl < lo)) {
                        hi = kh;
                        lo = kl;
                    }
                }
            }
            const unsigned best_hi = __reduce_min_sync(FULL, hi);
            const unsigned best_lo =
                __reduce_min_sync(FULL, hi == best_hi ? lo : 0xffffffffu);
            const int j = (int)(best_lo & 0xffffu);
            const int slot = j >> 5;
            int mine = r4c[0];
#pragma unroll
            for (int s = 1; s < CPL; ++s) mine = slot == s ? r4c[s] : mine;
            const int r4c_j = __shfl_sync(FULL, mine, j & 31);
            if ((j & 31) == lane) scanned |= 1u << slot;
            if (r4c_j == -1) sink = j;
            else i = r4c_j;
            minv = from_ordered(best_hi);
            ++k;
        }
        total_steps += k;
        sink = max(sink, 0);

        // ---- Dual update (keeps later reduced costs non-negative).
        int bad = 0;
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
            const int c = lane + 32 * s;
            if (c < C) {
                spc_s[c] = spc[s];
                path_s[c] = path[s];
                bad += isfinite(spc[s]) ? 0 : 1;
                if ((scanned >> s) & 1u) v[s] = v[s] - (minv - spc[s]);
            }
        }
        const int spcbad = (int)__reduce_add_sync(FULL, (unsigned)bad);
        __syncwarp();
        bad = 0;
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
            const int r = lane + 32 * s;
            if (r < R) {
                if (r == row) {
                    u[r] = u[r] + minv;
                } else if ((tree >> s) & 1u) {
                    const float at = onehot_read(spc_s[max(c4r[r], 0)], spcbad);
                    u[r] = (u[r] + minv) - at;
                }
                bad += isfinite(u[r]) ? 0 : 1;
            }
        }
        ubad = (int)__reduce_add_sync(FULL, (unsigned)bad);
        __syncwarp();

        // ---- Augment along predecessors from the sink back to `row`.
        if (lane == 0) {
            int jj = sink;
            bool done = false;
            for (int ka = 0; !done && ka <= R; ++ka) {
                const bool on = jj >= 0 && jj < C;
                const int i_p = on ? path_s[jj] : 0;
                const int safe_i = max(i_p, 0);
                if (on) r4c_s[jj] = safe_i;
                const int nxt = c4r[safe_i];
                c4r[safe_i] = jj;
                jj = nxt;
                done = i_p == row;
            }
        }
        __syncwarp();
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
            const int c = lane + 32 * s;
            if (c < C) r4c[s] = r4c_s[c];
        }
    }
    for (int r = lane; r < R; r += THREADS)
        col4row[(size_t)b * R + r] = c4r[r];
    if (steps != nullptr && lane == 0) steps[b] = total_steps;
}

template <int CPL>
int launch(const float* cost, const int* num_rows, int* col4row, int* steps,
           int B, int R, int C, size_t smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lsa_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    lsa_kernel<CPL><<<B, THREADS, smem, stream>>>(cost, num_rows, col4row,
                                                 steps, R, C);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k4_max_cols() { return 32 * 4; }

size_t k4_smem_bytes(int R, int C) {
    return (size_t)R * C * 4 + (size_t)C * 4 * 3 + (size_t)R * 4 * 2;
}

int k4_lsa(const float* cost, const int* num_rows, int* col4row, int* steps,
           int B, int R, int C, cudaStream_t stream) {
    if (R < 0 || C < R || C > k4_max_cols())
        return (int)cudaErrorInvalidValue;
    if (B == 0 || R == 0) return 0;
    const size_t smem = k4_smem_bytes(R, C);
    return C <= 64 ? launch<2>(cost, num_rows, col4row, steps, B, R, C, smem,
                               stream)
                   : launch<4>(cost, num_rows, col4row, steps, B, R, C, smem,
                               stream);
}

}  // extern "C"
