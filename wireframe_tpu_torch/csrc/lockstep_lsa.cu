// K4: batched rectangular Jonker-Volgenant assignment, hand-written for
// Hopper (sm_90a).
//
// Replaces wireframe_tpu/ops/pallas_lsa.py:solve_lsa_rows_pallas (body
// _lockstep_solve).  The TPU kernel runs every sample of the batch in
// lockstep under masks, because a TPU core has one instruction stream;
// each sample's solve is independent of the others, and the lockstep only
// freezes a sample whose loop has ended.  Here each sample gets its own
// block, so nothing is masked and a sample ends when its own loops end.
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
// latency of one scan step.  The variant is a function of (R, C) alone
// (k4_plan; ops/lockstep_lsa.py:k4_plan mirrors it):
//
// WARP (C <= 512): one warp per sample, each lane owning columns
//   lane + 32 k (k < CPL: 2 for C <= 64, 4 for C <= 128, 8 for C <= 256,
//   16 for C <= 512) with their spc, v, path, r4c and scanned bit in
//   registers;
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
//     scan's path.  Only the cost row and u[i] are loads.
//   The (R, C) costs sit in shared memory while they fit beside the
//   block's other arrays (227 KB); otherwise each scan step reads its cost
//   row from device memory, where a sample's costs stay resident in L2
//   (and mostly in L1: the block uses little shared memory then).
//
// BLOCK (C > 512): one block of W = min(32, ceil(C / 256)) warps per
//   sample, thread t owning columns t + 32 W k.  A scan step relaxes the
//   thread's columns, takes the same packed-key minimum in two levels
//   (redux.sync within each warp, then across the warps through a
//   double-buffered slot array in shared memory at one barrier: a slot
//   written at step k is rewritten at step k + 2, after every thread has
//   passed step k + 1's barrier) and every thread then knows j.  The
//   column state (v, spc, path, r4c, the scanned bit) and the row state
//   (u, the column of each row, the scan that last visited each row) live
//   in shared memory while they fit (C up to ~12,000), in a per-sample
//   scratch area of device memory beyond that; the costs in shared memory
//   while they fit beside the state, in device memory otherwise.  Each
//   column's state is touched during a scan by its owner thread only; the
//   dual update and the augmentation read it after a barrier.
//
// The dual update and the augmentation run once per row, the augmentation
// on one thread.
//
// The TPU body reads every dynamic index as a one-hot multiply-and-sum,
// where 0 * inf and 0 * NaN are NaN.  The kernel reproduces that, so it
// stays array_equal to the plain version for non-finite costs too: a cost
// reads as NaN when another row of its column is not finite (folded into
// the shared copy of the costs once; with the costs in device memory,
// each column's count of non-finite rows, capped at 2, is taken once and
// applied on every read), u[i] when another row's dual is not finite, spc
// at a row's column when another column's spc is not finite; an
// augmenting step from a column index off the matrix reads path 0 and
// writes no r4c.  The optional `steps` output counts the scan steps this
// input needed, so a bound can be computed from the work done.
//
// Interface: plain C, loaded with ctypes; launches on the given stream,
// allocates nothing (the block variant's device-memory state is a scratch
// buffer the caller passes), returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;   // one warp per sample (WARP)
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_MAX_COLS = 32 * 16;
constexpr int BLOCK_COLS_PER_WARP = 256;  // 8 columns a thread
constexpr int BLOCK_MAX_WARPS = 32;
constexpr size_t SMEM_LIMIT = 232448;     // shared memory a block may use
// BLOCK's fixed shared memory: two rounds of per-warp keys and a per-warp
// slot for block sums.
constexpr size_t BLOCK_FIXED = 2 * BLOCK_MAX_WARPS * 8 + BLOCK_MAX_WARPS * 4;

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
// count of non-finite entries summed over, x included; any count above 2
// may be given as 2) counts another.
__device__ __forceinline__ float onehot_read(float x, int bad) {
    const int others = bad - (isfinite(x) ? 0 : 1);
    return (x != x || others > 0) ? __uint_as_float(0x7fc00000u) : x;
}

// Non-finite entries of column c of a sample's (R, C) costs, capped at 2.
// No early exit, so the loads are independent and kept in flight.
__device__ __forceinline__ int column_bad(const float* cb, int R, int C,
                                          int c) {
    int bad = 0;
#pragma unroll 8
    for (int r = 0; r < R; ++r)
        bad += isfinite(__ldg(cb + (size_t)r * C + c)) ? 0 : 1;
    return min(bad, 2);
}

// ---------------------------------------------------------------------------
// WARP: C <= 32 CPL, column state in registers.  GCOST: the costs are read
// from device memory (they do not fit in shared memory).
// ---------------------------------------------------------------------------

template <int CPL, bool GCOST>
__global__ void __launch_bounds__(THREADS)
lsa_kernel(const float* __restrict__ cost, const int* __restrict__ num_rows,
           int* __restrict__ col4row, int* __restrict__ steps, int R, int C) {
    extern __shared__ float smem[];
    float* ce = smem;                              // (R, C) cost, one-hot read
    float* u = ce + (GCOST ? 0 : (size_t)R * C);   // (R,) row duals
    float* spc_s = u + R;                          // (C,) for the dual update
    int* path_s = reinterpret_cast<int*>(spc_s + C);   // (C,)
    int* r4c_s = path_s + C;                       // (C,) row of each column
    int* c4r = r4c_s + C;                          // (R,) column of each row

    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const float* cb = cost + (size_t)b * R * C;
    // GCOST: column lane + 32 s's non-finite count (capped at 2) in bits
    // 2 s, 2 s + 1.
    unsigned badbits = 0u;
    if constexpr (GCOST) {
        // Row by row, so a lane keeps CPL independent loads in flight.
        int bad[CPL];
#pragma unroll
        for (int s = 0; s < CPL; ++s) bad[s] = 0;
#pragma unroll 4
        for (int r = 0; r < R; ++r) {
            const float* row = cb + (size_t)r * C;
#pragma unroll
            for (int s = 0; s < CPL; ++s) {
                const int c = lane + 32 * s;
                if (c < C) bad[s] += isfinite(__ldg(row + c)) ? 0 : 1;
            }
        }
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
            const int c = lane + 32 * s;
            if (c < C) {
                badbits |= (unsigned)min(bad[s], 2) << (2 * s);
                r4c_s[c] = -1;
            }
        }
    } else {
        for (int c = lane; c < C; c += THREADS) {
            int bad = 0;
            for (int r = 0; r < R; ++r)
                bad += isfinite(cb[(size_t)r * C + c]) ? 0 : 1;
            for (int r = 0; r < R; ++r)
                ce[(size_t)r * C + c] = onehot_read(cb[(size_t)r * C + c],
                                                    bad);
            r4c_s[c] = -1;
        }
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
            const float* ci = GCOST ? cb + (size_t)i * C : ce + (size_t)i * C;
            unsigned hi = 0xffffffffu, lo = 0xffffffffu;
#pragma unroll
            for (int s = 0; s < CPL; ++s) {
                const int c = lane + 32 * s;
                if (c < C) {
                    const bool done = (scanned >> s) & 1u;
                    if (!done) {
                        const float cost_ic =
                            GCOST ? onehot_read(__ldg(ci + c),
                                                (badbits >> (2 * s)) & 3u)
                                  : ci[c];
                        const float red = ((minv + cost_ic) - u_i) - v[s];
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

// ---------------------------------------------------------------------------
// BLOCK: C > 512.  Column and row state in shared memory or in the
// caller's scratch (generic pointers reach either); costs in shared or
// device memory.
// ---------------------------------------------------------------------------

// Bytes of one sample's state: per column v, spc (f32), path, r4c (i32)
// and a flag byte (bit 0 scanned, bits 1-2 the non-finite count), padded
// to 16; per row u (f32), its column and the scan that last visited it.
__host__ __device__ __forceinline__ size_t block_state_bytes(int R, int C) {
    return ((size_t)C * 17 + 15) / 16 * 16 + (size_t)R * 12;
}

struct BlockState {
    float* v;
    float* spc;
    int* path;
    int* r4c;
    float* u;
    int* c4r;
    int* stamp;
    uint8_t* flags;
};

__device__ __forceinline__ BlockState block_state(uint8_t* base, int R,
                                                  int C) {
    BlockState s;
    s.v = reinterpret_cast<float*>(base);
    s.spc = s.v + C;
    s.path = reinterpret_cast<int*>(s.spc + C);
    s.r4c = s.path + C;
    s.u = reinterpret_cast<float*>(s.r4c + C);
    s.c4r = reinterpret_cast<int*>(s.u + R);
    s.stamp = s.c4r + R;
    s.flags = reinterpret_cast<uint8_t*>(s.stamp + R);
    return s;
}

// Sum of one int per thread over the block, in warp order (every thread
// gets it).  `red` holds a slot per warp; two barriers.
__device__ __forceinline__ int block_sum(int x, int* red, int warps) {
    const unsigned w = __reduce_add_sync(FULL, (unsigned)x);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (int)w;
    __syncthreads();
    int s = 0;
    for (int k = 0; k < warps; ++k) s += red[k];
    __syncthreads();
    return s;
}

__global__ void __launch_bounds__(BLOCK_MAX_WARPS * 32)
lsa_block_kernel(const float* __restrict__ cost,
                 const int* __restrict__ num_rows, int* __restrict__ col4row,
                 int* __restrict__ steps, uint8_t* __restrict__ scratch,
                 int R, int C, int state_smem, int cost_smem) {
    extern __shared__ __align__(16) uint8_t bsmem[];
    unsigned long long* keys =
        reinterpret_cast<unsigned long long*>(bsmem);   // [2][warps]
    int* red = reinterpret_cast<int*>(keys + 2 * BLOCK_MAX_WARPS);
    uint8_t* state_base = bsmem + BLOCK_FIXED;
    const size_t state_bytes = block_state_bytes(R, C);

    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int T = blockDim.x;
    const int warps = T >> 5;
    const int lane = t & 31, warp = t >> 5;
    const float* cb = cost + (size_t)b * R * C;
    const BlockState st = block_state(
        state_smem ? state_base : scratch + (size_t)b * state_bytes, R, C);
    float* ce = cost_smem
        ? reinterpret_cast<float*>(state_base + state_bytes) : nullptr;

    for (int c = t; c < C; c += T) {
        const int bad = column_bad(cb, R, C, c);
        if (cost_smem)
            for (int r = 0; r < R; ++r)
                ce[(size_t)r * C + c] = onehot_read(cb[(size_t)r * C + c],
                                                    bad);
        st.v[c] = 0.0f;
        st.r4c[c] = -1;
        st.flags[c] = (uint8_t)(bad << 1);
    }
    for (int r = t; r < R; r += T) {
        st.u[r] = 0.0f;
        st.c4r[r] = -1;
        st.stamp[r] = 0;
    }
    __syncthreads();
    const int nr = min(max(num_rows[b], 0), R);
    int total_steps = 0;
    int ubad = 0;                   // non-finite entries of u

    for (int row = 0; row < nr; ++row) {
        for (int c = t; c < C; c += T) {
            st.spc[c] = INFINITY;
            st.path[c] = -1;
            st.flags[c] &= (uint8_t)~1u;
        }
        __syncthreads();
        float minv = 0.0f;
        int i = row, sink = -1, k = 0;
        // ---- Dijkstra scan: i, minv, sink and k are the same on every
        // thread.
        while (sink < 0 && k <= C) {
            if (t == 0) st.stamp[i] = row + 1;
            const float u_i = onehot_read(st.u[i], ubad);
            const float* ci = cost_smem ? ce + (size_t)i * C
                                        : cb + (size_t)i * C;
            unsigned hi = 0xffffffffu, lo = 0xffffffffu;
            for (int c = t; c < C; c += T) {
                const unsigned f = st.flags[c];
                const bool done = f & 1u;
                float sp = st.spc[c];
                if (!done) {
                    const float cost_ic =
                        cost_smem ? ci[c] : onehot_read(__ldg(ci + c),
                                                        (int)(f >> 1));
                    const float red_c = ((minv + cost_ic) - u_i) - st.v[c];
                    if (red_c < sp) {
                        sp = red_c;
                        st.spc[c] = red_c;
                        st.path[c] = i;
                    }
                }
                const float cand = done ? INFINITY : sp;
                const unsigned kh = ordered(cand);
                const unsigned kl = cand != cand
                    ? (unsigned)(C - 1)
                    : ((st.r4c[c] != -1 ? 0x80000000u : 0u) | (unsigned)c);
                if (kh < hi || (kh == hi && kl < lo)) {
                    hi = kh;
                    lo = kl;
                }
            }
            const unsigned wh = __reduce_min_sync(FULL, hi);
            const unsigned wl =
                __reduce_min_sync(FULL, hi == wh ? lo : 0xffffffffu);
            unsigned long long* round = keys + (k & 1) * BLOCK_MAX_WARPS;
            if (lane == 0)
                round[warp] = ((unsigned long long)wh << 32) | wl;
            __syncthreads();
            unsigned long long best = round[0];
            for (int w = 1; w < warps; ++w) best = min(best, round[w]);
            const int j = (int)(best & 0x7fffffffu);
            if (j % T == t) st.flags[j] |= 1u;
            const int r4c_j = st.r4c[j];
            if (r4c_j == -1) sink = j;
            else i = r4c_j;
            minv = from_ordered((unsigned)(best >> 32));
            ++k;
        }
        total_steps += k;
        sink = max(sink, 0);
        __syncthreads();

        // ---- Dual update (keeps later reduced costs non-negative).
        int bad = 0;
        for (int c = t; c < C; c += T) {
            const float sp = st.spc[c];
            bad += isfinite(sp) ? 0 : 1;
            if (st.flags[c] & 1u) st.v[c] = st.v[c] - (minv - sp);
        }
        const int spcbad = block_sum(bad, red, warps);
        bad = 0;
        for (int r = t; r < R; r += T) {
            if (r == row) {
                st.u[r] = st.u[r] + minv;
            } else if (st.stamp[r] == row + 1) {
                const float at =
                    onehot_read(st.spc[max(st.c4r[r], 0)], spcbad);
                st.u[r] = (st.u[r] + minv) - at;
            }
            bad += isfinite(st.u[r]) ? 0 : 1;
        }
        ubad = block_sum(bad, red, warps);

        // ---- Augment along predecessors from the sink back to `row`.
        if (t == 0) {
            int jj = sink;
            bool done = false;
            for (int ka = 0; !done && ka <= R; ++ka) {
                const bool on = jj >= 0 && jj < C;
                const int i_p = on ? st.path[jj] : 0;
                const int safe_i = max(i_p, 0);
                if (on) st.r4c[jj] = safe_i;
                const int nxt = st.c4r[safe_i];
                st.c4r[safe_i] = jj;
                jj = nxt;
                done = i_p == row;
            }
        }
        __syncthreads();
    }
    for (int r = t; r < R; r += T)
        col4row[(size_t)b * R + r] = st.c4r[r];
    if (steps != nullptr && t == 0) steps[b] = total_steps;
}

// ---------------------------------------------------------------------------
// The plan (ops/lockstep_lsa.py:k4_plan mirrors it)
// ---------------------------------------------------------------------------

struct Plan {
    int block;          // 0: WARP, 1: BLOCK
    int threads;
    int cols_per_thread;
    int cost_smem;      // costs in shared memory
    int state_smem;     // BLOCK: state in shared memory (WARP: registers)
    size_t smem;        // dynamic shared memory of a launch
    size_t scratch;     // device-memory state per sample (BLOCK)
};

Plan plan_for(int R, int C) {
    Plan p{};
    if (C <= WARP_MAX_COLS) {
        p.block = 0;
        p.threads = THREADS;
        p.cols_per_thread = C <= 64 ? 2 : (C <= 128 ? 4 : (C <= 256 ? 8 : 16));
        p.state_smem = 0;
        const size_t arrays = (size_t)C * 4 * 3 + (size_t)R * 4 * 2;
        const size_t with_costs = (size_t)R * C * 4 + arrays;
        p.cost_smem = with_costs <= SMEM_LIMIT;
        p.smem = p.cost_smem ? with_costs : arrays;
        p.scratch = 0;
        return p;
    }
    int warps = (C + BLOCK_COLS_PER_WARP - 1) / BLOCK_COLS_PER_WARP;
    warps = warps < BLOCK_MAX_WARPS ? warps : BLOCK_MAX_WARPS;
    p.block = 1;
    p.threads = 32 * warps;
    p.cols_per_thread = (C + p.threads - 1) / p.threads;
    const size_t state = block_state_bytes(R, C);
    p.state_smem = BLOCK_FIXED + state <= SMEM_LIMIT;
    p.cost_smem =
        p.state_smem && BLOCK_FIXED + state + (size_t)R * C * 4 <= SMEM_LIMIT;
    p.smem = BLOCK_FIXED + (p.state_smem ? state : 0) +
             (p.cost_smem ? (size_t)R * C * 4 : 0);
    p.scratch = p.state_smem ? 0 : state;
    return p;
}

template <int CPL>
int launch_warp(const Plan& p, const float* cost, const int* num_rows,
                int* col4row, int* steps, int B, int R, int C,
                cudaStream_t stream) {
    auto kernel = p.cost_smem ? lsa_kernel<CPL, false> : lsa_kernel<CPL, true>;
    if (p.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)p.smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<B, THREADS, p.smem, stream>>>(cost, num_rows, col4row, steps, R,
                                           C);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Field `which` of the plan for an (R, C) problem: 0 variant (0 WARP, 1
// BLOCK), 1 threads, 2 columns per thread, 3 costs in shared memory, 4
// state in shared memory, 5 dynamic shared-memory bytes, 6 scratch bytes
// per sample; -1 for another `which`.
long long k4_plan(int R, int C, int which) {
    const Plan p = plan_for(R, C);
    switch (which) {
        case 0: return p.block;
        case 1: return p.threads;
        case 2: return p.cols_per_thread;
        case 3: return p.cost_smem;
        case 4: return p.state_smem;
        case 5: return (long long)p.smem;
        case 6: return (long long)p.scratch;
        default: return -1;
    }
}

// col4row (B, R) of cost (B, R, C), num_rows (B,); steps (B,) or null;
// scratch: B * k4_plan(R, C, 6) bytes when that is not 0, else unused.
int k4_lsa(const float* cost, const int* num_rows, int* col4row, int* steps,
           void* scratch, int B, int R, int C, cudaStream_t stream) {
    if (R < 0 || C < R) return (int)cudaErrorInvalidValue;
    if (B == 0 || R == 0) return 0;
    const Plan p = plan_for(R, C);
    if (!p.block) {
        switch (p.cols_per_thread) {
            case 2: return launch_warp<2>(p, cost, num_rows, col4row, steps,
                                          B, R, C, stream);
            case 4: return launch_warp<4>(p, cost, num_rows, col4row, steps,
                                          B, R, C, stream);
            case 8: return launch_warp<8>(p, cost, num_rows, col4row, steps,
                                          B, R, C, stream);
            default: return launch_warp<16>(p, cost, num_rows, col4row,
                                            steps, B, R, C, stream);
        }
    }
    if (p.scratch != 0 && scratch == nullptr)
        return (int)cudaErrorInvalidValue;
    if (p.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lsa_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)p.smem);
        if (e != cudaSuccess) return (int)e;
    }
    lsa_block_kernel<<<B, p.threads, p.smem, stream>>>(
        cost, num_rows, col4row, steps, static_cast<uint8_t*>(scratch), R, C,
        p.state_smem, p.cost_smem);
    return (int)cudaGetLastError();
}

}  // extern "C"
