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
// W_above^T backward) and the two kernels here do the rest:
//   ln_fwd_rows_kernel  h = relu(LayerNorm(z)) in the operand type from
//                       the f32 z (eps 1e-6, centred variance), and the
//                       bf16 stash of z when asked (K2 in bf16; in f32 the
//                       stash is the f32 z itself);
//   ln_bwd_rows_kernel  from the stage's z (the bf16 stash, K3 in bf16; the
//                       f32 z, K3 in f32 and K5) and the f32 dh: dz =
//                       (dxhat - m1 - xhat m2) rstd with dln = dh where
//                       ln > 0, 0 where ln < 0 and dh / 2 where ln == 0, the
//                       rebuilt h (K3), and each 128-row tile's column
//                       partials of d gamma, d beta and d b, which the
//                       caller sums over the tiles in order (chain_grad.cu's
//                       k3_colsum), as it does the fused epilogue's.  One
//                       launch.
//
// What bounds them on this card: bytes.  Per element the forward reads
// the f32 z and writes h (and the stash): 8 B in bf16 and in f32; the
// backward reads z and the f32 dh and writes dz and h: 10 B in bf16, 16 B
// in f32.  At (20480, 4096) that is 0.20, 0.25 and 0.40 ms at 3.35 TB/s.
// So the design reads every input byte from device memory once and moves
// it 16 bytes at a time:
//   - A row is cut into units of 8 columns (16 bytes of bf16, 32 of f32);
//     thread t of a block of T takes units t + T i (i < 2) of each staged
//     chunk of 16 T columns, so neighbouring threads touch neighbouring
//     16-byte words.  Rows must start 16-byte aligned (the wrappers'
//     buffers have rows a multiple of 8 elements apart); the ragged tail
//     of a width that is not a multiple of 8 is copied with cp.async's
//     zero fill and stored element by element.
//   - Each thread copies its own units of the next stages into a ring of
//     `ring` slots in shared memory with 16-byte cp.async (one commit group
//     a stage) while it works on the current one, so no barrier guards the
//     ring: a thread waits for its own groups and reads only what it
//     copied.  gamma and beta come into shared memory once per block.
//   - Mode "resident" (W <= 8192): one stage is one whole row (T = 32
//     ceil(W / 512)), held in registers for its passes.  Mode "column
//     chunks" (wider): T = 256 and a stage is a chunk of 4096 columns; the
//     forward reads each row twice (statistics, then output), the backward
//     three times (statistics; the sums of dxhat and dxhat xhat; then,
//     chunk by chunk over the block's rows, the outputs and the column
//     partials), with the same fixed-order sums.
//   - Row statistics: each thread sums its units in four chains (column e
//     of a unit into chain e mod 4, unit by unit) joined as (0 + 1) + (2 +
//     3), a warp by an xor butterfly (every lane gets the same bits), the
//     block by a second butterfly over the warps' partials read back from
//     shared memory (a sequential sum of them here was the backward's
//     largest cost).  Per chunk: its mean (the sum times 1 / count), then
//     its centred M2 about that mean; chunks are merged in order (Chan:
//     mean += d nk / n, M2 += M2k + d^2 na nk / n), never E[z^2] - E[z]^2,
//     which a row mean of 1e3 would cancel away.  A resident row is one
//     chunk: the plain two-pass centred variance.
//     (tests/test_torch_layernorm_rows.py emulates this order.)
//   - The backward runs a 128-row tile on a cluster of `cluster` CTAs, 128
//     / cluster rows each, so the grid has several waves (1280 CTAs at M =
//     20480).  Each thread keeps its columns' d gamma, d beta and d b in
//     registers over its CTA's rows in order; the cluster then adds the
//     CTAs' partials in rank order through distributed shared memory,
//     each CTA writing a share of the tile's `part` row.
// On the card (PERF.md, PR 15) the forward runs at about four fifths of
// its bytes bound, the backward at about 70% in bf16 and 75% in f32: its
// 48 partial registers a thread hold it to 2 blocks of 8 warps an SM, and
// its 3 block sums a row, each a barrier, are its per-row latency.
// The plan (ops/layernorm_rows.py:rows_plan) chooses the block, ring,
// rows per CTA, cluster and shared-memory bytes; every entry point checks
// them against this file's layout and raises cudaErrorInvalidValue on
// anything else.  No float atomics: two launches give the same bits, and
// a row's bits depend on W alone (not on M or the grid), so K1, K2 and K5
// get the same h from the same z.
//
// Interface: plain C, loaded with ctypes.  Every function launches on the
// stream it is given, allocates nothing, and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int VEC = 8;                // columns a unit
constexpr int UNITS = 2;              // units a thread takes of each stage
constexpr int MAX_THREADS = 512;      // resident rows up to 8 x 2 x 512
constexpr int CHUNK_THREADS = 256;    // column chunks of 8 x 2 x 256
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int ROW_TILE = 128;         // rows of a partial (the GEMM's BM)
constexpr int MAX_RING = 4;
constexpr int MAX_CLUSTER = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr float EPS = 1e-6f;

enum Kind { ALL, STATS, SUMS, OUT };

// Byte offsets of a block's dynamic shared memory: gamma | beta (resident
// mode), the ring of `ring` slots (a slot: the stage's z, then dh in the
// backward), the cluster's partial exchange (backward: 3 chunk floats;
// aliased onto the ring in resident mode, where it is written after the
// last stage), the rows' (mean, rstd, m1, m2) (backward, column chunks)
// and the block sums' double-buffered scratch.
struct Layout {
    int gb, ring, slot, part, stats, red, total;
};

__host__ __device__ inline Layout layout(int bwd, int zsize, int chunk,
                                         int nch, int ring, int rows) {
    Layout l;
    const bool resident = nch == 1;
    l.slot = chunk * (bwd ? zsize + 4 : 4);
    int off = 0;
    l.gb = off;
    if (resident) off += 2 * chunk * 4;
    l.ring = off;
    const int ring_bytes = ring * l.slot;
    const int part_bytes = bwd ? 3 * chunk * 4 : 0;
    if (resident) {
        l.part = off;
        off += ring_bytes > part_bytes ? ring_bytes : part_bytes;
    } else {
        off += ring_bytes;
        l.part = off;
        off += part_bytes;
    }
    l.stats = off;
    if (bwd && !resident) off += rows * 16;
    l.red = off;
    off += 2 * MAX_WARPS * 2 * 4;
    l.total = off;
    return l;
}

struct Args {
    const void* z;
    const float* dh;
    const float* gamma;
    const float* beta;
    void* h;       // forward: h; backward: the rebuilt h (null: none)
    void* s;       // forward: the bf16 stash (null: none)
    void* dz;      // backward
    float* part;   // backward: (ceil(M / 128), 3 N)
    int ldz, lddh, ldh, lds, lddz;
    int M, N, chunk, nch, rows, ring;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without registers; the bytes
// past `bytes` (0..16) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` (< MAX_RING) of this thread's groups are
// in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
    switch (pending) {
        case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    }
}

// A unit's n (1..8) valid elements into a slot of 8.
__device__ __forceinline__ void copy8(float* dst, const float* src, int n) {
    cp_async16(dst, src, 4 * min(n, 4));
    cp_async16(dst + 4, n > 4 ? src + 4 : src, 4 * max(0, min(n - 4, 4)));
}
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int n) {
    cp_async16(dst, src, 2 * min(n, VEC));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(q[k]);
        x[2 * k] = f.x;
        x[2 * k + 1] = f.y;
    }
}

// n valid floats from device memory (16-byte loads when whole), 0 past n.
__device__ __forceinline__ void ldg8(const float* p, int n, float (&x)[VEC]) {
    if (n >= VEC) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
        x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
        x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
        return;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = e < n ? __ldg(p + e) : 0.0f;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[VEC],
                                       int n) {
    if (n >= VEC) {
        reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
        reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
        return;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
        if (e < n) p[e] = x[e];
}
__device__ __forceinline__ void store8(bf16* p, const float (&x)[VEC],
                                       int n) {
    if (n >= VEC) {
        uint4 u;
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            q[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
        *reinterpret_cast<uint4*>(p) = u;
        return;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
        if (e < n) p[e] = __float2bfloat16(x[e]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// The block's sums of v, the same bits in every thread: an xor butterfly
// in each warp, then every warp runs the same butterfly over the warps'
// partials (lane w holding warp w's, 0 past the last warp), so no thread
// adds them one after another.  `red` holds two buffers used in turn, so
// one barrier a sum suffices (a buffer is rewritten two sums later, after
// every thread has passed the sum in between).
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red,
                                          int& buf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    float* r = red + buf * (MAX_WARPS * 2);
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = warp_sum(v[k]);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) r[warp * NV + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k)
        v[k] = warp_sum(lane < nw ? r[lane * NV + k] : 0.0f);
    buf ^= 1;
}

struct Stats {
    float n, mean, m2;
};

// A thread's sum over its columns runs as four chains, column c into
// chain c mod 4 in unit and column order, joined as (0 + 1) + (2 + 3).
__device__ __forceinline__ float lanes4(const float (&acc)[4]) {
    return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Merge chunk k (nk valid columns; x: this thread's units, nv[u] valid
// each) into the row's (count, mean, centred M2), chunks in order.
__device__ __forceinline__ void chunk_stats(const float (&x)[UNITS][VEC],
                                            const int (&nv)[UNITS], int nk,
                                            int k, float* red, int& buf,
                                            Stats& st) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
            if (e < nv[u]) acc[e & 3] += x[u][e];
    float s[1] = {lanes4(acc)};
    block_sum<1>(s, red, buf);
    const float fk = (float)nk;
    const float mk = s[0] * (1.0f / fk);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
            if (e < nv[u]) {
                const float d = x[u][e] - mk;
                acc[e & 3] += d * d;
            }
    float q[1] = {lanes4(acc)};
    block_sum<1>(q, red, buf);
    if (k == 0) {
        st.n = fk;
        st.mean = mk;
        st.m2 = q[0];
    } else {
        const float n = st.n + fk, d = mk - st.mean;
        st.mean += d * (fk / n);
        st.m2 += q[0] + d * d * (st.n * fk / n);
        st.n = n;
    }
}

__device__ __forceinline__ float row_rstd(const Stats& st, int n) {
    return rsqrtf(st.m2 * (1.0f / (float)n) + EPS);
}

// dln of the ReLU with jnp.maximum's tie rule.
__device__ __forceinline__ float relu_grad(float ln, float g) {
    return ln > 0.0f ? g : (ln < 0.0f ? 0.0f : 0.5f * g);
}

// Valid columns of unit u of chunk k for thread t of nt.
__device__ __forceinline__ int unit_cols(const Args& a, int k, int u, int t,
                                         int nt) {
    return a.N - k * a.chunk - VEC * (t + u * nt);
}

__device__ __forceinline__ int clamp8(int n) {
    return n < 0 ? 0 : (n > VEC ? VEC : n);
}

// This thread's units of gamma and beta into shared memory (resident
// mode; part of the first stage's commit group).
__device__ __forceinline__ void copy_gb(const Args& a, float* gb, int t,
                                        int nt) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
        const int lc = VEC * (t + u * nt), n = a.N - lc;
        if (n > 0) {
            copy8(gb + lc, a.gamma + lc, n);
            copy8(gb + a.chunk + lc, a.beta + lc, n);
        }
    }
}

// gamma and beta of one unit: from shared memory (resident) or device
// memory (column chunks).
__device__ __forceinline__ void unit_gb(const Args& a, const float* gb,
                                        bool smem, int k, int lc, int n,
                                        float (&g)[VEC], float (&b)[VEC]) {
    if (smem) {
        load8(gb + lc, g);
        load8(gb + a.chunk + lc, b);
    } else {
        ldg8(a.gamma + k * a.chunk + lc, n, g);
        ldg8(a.beta + k * a.chunk + lc, n, b);
    }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Stage j of a forward block: row j / per_row; resident, the whole row;
// column chunks, chunk (j % per_row) % nch, its statistics pass first.
__device__ __forceinline__ void fwd_issue(const Args& a, const Layout& L,
                                          unsigned char* sm, int j, int nst,
                                          int per_row, int r0, int t,
                                          int nt) {
    if (j < nst) {
        const int i = j / per_row, k = (j % per_row) % a.nch;
        const float* zrow = static_cast<const float*>(a.z) +
                            (size_t)(r0 + i) * a.ldz + (size_t)k * a.chunk;
        float* slot = reinterpret_cast<float*>(sm + L.ring +
                                               (j % a.ring) * L.slot);
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            const int lc = VEC * (t + u * nt), n = unit_cols(a, k, u, t, nt);
            if (n > 0) copy8(slot + lc, zrow + lc, n);
        }
    }
    cp_async_commit();
}

// H = relu(LayerNorm(Z)) in T; S (bf16, null: none) = Z rounded.  Block
// b takes rows [b rows, (b + 1) rows).
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
ln_fwd_rows_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char sm[];
    const Layout L = layout(0, 4, a.chunk, a.nch, a.ring, a.rows);
    const int t = threadIdx.x, nt = blockDim.x;
    const int r0 = blockIdx.x * a.rows;
    const int nrows = min(a.rows, a.M - r0);
    const bool resident = a.nch == 1;
    const int per_row = resident ? 1 : 2 * a.nch;
    const int nst = nrows * per_row;
    float* gb = reinterpret_cast<float*>(sm + L.gb);
    float* red = reinterpret_cast<float*>(sm + L.red);
    int buf = 0;
    if (resident) copy_gb(a, gb, t, nt);
    for (int j = 0; j + 1 < a.ring; ++j)
        fwd_issue(a, L, sm, j, nst, per_row, r0, t, nt);
    Stats st{0.0f, 0.0f, 0.0f};
    float rstd = 0.0f;
    for (int j = 0; j < nst; ++j) {
        fwd_issue(a, L, sm, j + a.ring - 1, nst, per_row, r0, t, nt);
        cp_async_wait(a.ring - 1);
        const int i = j / per_row, kk = j % per_row, k = kk % a.nch;
        const bool stats_pass = kk < a.nch;
        const float* slot = reinterpret_cast<const float*>(
            sm + L.ring + (j % a.ring) * L.slot);
        float x[UNITS][VEC];
        int nv[UNITS];
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            nv[u] = clamp8(unit_cols(a, k, u, t, nt));
            if (nv[u] > 0) {
                load8(slot + VEC * (t + u * nt), x[u]);
            } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e) x[u][e] = 0.0f;
            }
        }
        if (stats_pass) {
            chunk_stats(x, nv, min(a.chunk, a.N - k * a.chunk), k, red, buf,
                        st);
            if (k == a.nch - 1) rstd = row_rstd(st, a.N);
        }
        if (!resident && stats_pass) continue;
        const size_t row = (size_t)(r0 + i);
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            if (nv[u] == 0) continue;
            const int lc = VEC * (t + u * nt);
            const size_t c = (size_t)k * a.chunk + lc;
            float g[VEC], b[VEC], h[VEC];
            unit_gb(a, gb, resident, k, lc, nv[u], g, b);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                h[e] = fmaxf((x[u][e] - st.mean) * rstd * g[e] + b[e], 0.0f);
            store8(static_cast<T*>(a.h) + row * a.ldh + c, h, nv[u]);
            if (a.s != nullptr)
                store8(static_cast<bf16*>(a.s) + row * a.lds + c, x[u],
                       nv[u]);
        }
    }
    cp_async_wait(0);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_ranks() {
    uint32_t n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
    return n;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The last barrier: it only keeps every CTA alive until its peers have
// read its shared memory (values they have already used).
__device__ __forceinline__ void cluster_sync_last() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
                 "barrier.cluster.wait.aligned;" ::: "memory");
}

// The float at shared address `local` in the CTA of cluster rank `rank`.
__device__ __forceinline__ float ld_cluster(uint32_t local, uint32_t rank) {
    uint32_t remote;
    float v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("ld.shared::cluster.f32 %0, [%1];"
                 : "=f"(v) : "r"(remote) : "memory");
    return v;
}

// Stage j of a backward block with nrows rows: resident, row j (z and
// dh); column chunks, first for each row its statistics chunks (z) and
// its sums chunks (z and dh), nst1 stages in all, then for each chunk
// the block's rows in order (z and dh).
__device__ __forceinline__ void bwd_stage(int nch, int j, int nst1,
                                          int nrows, int& i, int& k,
                                          int& kind) {
    if (nch == 1) {
        i = j;
        k = 0;
        kind = ALL;
    } else if (j < nst1) {
        i = j / (2 * nch);
        const int kk = j % (2 * nch);
        k = kk % nch;
        kind = kk < nch ? STATS : SUMS;
    } else {
        k = (j - nst1) / nrows;
        i = (j - nst1) % nrows;
        kind = OUT;
    }
}

template <typename ZT>
__device__ __forceinline__ void bwd_issue(const Args& a, const Layout& L,
                                          unsigned char* sm, int j, int nst,
                                          int nst1, int nrows, int r0, int t,
                                          int nt) {
    if (j < nst) {
        int i, k, kind;
        bwd_stage(a.nch, j, nst1, nrows, i, k, kind);
        const size_t row = (size_t)(r0 + i), c0 = (size_t)k * a.chunk;
        const ZT* zrow = static_cast<const ZT*>(a.z) + row * a.ldz + c0;
        const float* drow = a.dh + row * a.lddh + c0;
        unsigned char* slot = sm + L.ring + (j % a.ring) * L.slot;
        ZT* zs = reinterpret_cast<ZT*>(slot);
        float* ds = reinterpret_cast<float*>(slot + (size_t)a.chunk *
                                                        sizeof(ZT));
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            const int lc = VEC * (t + u * nt), n = unit_cols(a, k, u, t, nt);
            if (n > 0) {
                copy8(zs + lc, zrow + lc, n);
                if (kind != STATS) copy8(ds + lc, drow + lc, n);
            }
        }
    }
    cp_async_commit();
}

// One unit's dz and h (hp null: none), and its columns' partials.
template <typename T>
__device__ __forceinline__ void out_unit(const float (&x)[VEC],
                                         const float (&d)[VEC],
                                         const float (&g)[VEC],
                                         const float (&b)[VEC], int n,
                                         float mean, float rstd, float m1,
                                         float m2, T* dzp, T* hp,
                                         float (&cg)[VEC], float (&cb)[VEC],
                                         float (&cz)[VEC]) {
    float dz[VEC], h[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
        const float xhat = (x[e] - mean) * rstd;
        const float ln = xhat * g[e] + b[e];
        const float dln = relu_grad(ln, d[e]);
        dz[e] = (dln * g[e] - m1 - xhat * m2) * rstd;
        h[e] = fmaxf(ln, 0.0f);
        if (e < n) {
            cg[e] += dln * xhat;
            cb[e] += dln;
            cz[e] += dz[e];
        }
    }
    store8(dzp, dz, n);
    if (hp != nullptr) store8(hp, h, n);
}

// The tile's column partials of chunk k: every CTA's in rank order.
__device__ __forceinline__ void cluster_part(
    const Args& a, const Layout& L, unsigned char* sm,
    const float (&cg)[UNITS][VEC], const float (&cb)[UNITS][VEC],
    const float (&cz)[UNITS][VEC], int k, int tile, uint32_t rank,
    uint32_t ranks, bool last) {
    const int t = threadIdx.x, nt = blockDim.x;
    float* P = reinterpret_cast<float*>(sm + L.part);
    if (a.nch == 1) {  // P aliases the ring
        cp_async_wait(0);
        __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
        const int lc = VEC * (t + u * nt);
        store8(P + lc, cg[u], VEC);
        store8(P + a.chunk + lc, cb[u], VEC);
        store8(P + 2 * a.chunk + lc, cz[u], VEC);
    }
    cluster_sync();
    const int nk = min(a.chunk, a.N - k * a.chunk);
    const int total = 3 * nk, share = (total + ranks - 1) / ranks;
    const int e0 = rank * share, e1 = min(total, e0 + share);
    const uint32_t base = smem_u32(P);
    float* out = a.part + (size_t)tile * 3 * a.N + (size_t)k * a.chunk;
    for (int e = e0 + t; e < e1; e += nt) {
        const int q = e / nk, c = e - q * nk;
        const uint32_t off = base + 4u * (uint32_t)(q * a.chunk + c);
        float s = 0.0f;
        for (uint32_t r = 0; r < ranks; ++r) s += ld_cluster(off, r);
        out[(size_t)q * a.N + c] = s;
    }
    if (last)
        cluster_sync_last();
    else
        cluster_sync();
}

// DZ and (H not null) the rebuilt h in T from ZT z and f32 dh; part[tile]
// [d gamma | d beta | d b][N].  Cluster rank r of tile b takes rows
// [128 b + r rows, 128 b + (r + 1) rows).
template <typename T, typename ZT>
__global__ void __launch_bounds__(MAX_THREADS)
ln_bwd_rows_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char sm[];
    const Layout L = layout(1, sizeof(ZT), a.chunk, a.nch, a.ring, a.rows);
    const int t = threadIdx.x, nt = blockDim.x;
    const uint32_t rank = cluster_rank(), ranks = cluster_ranks();
    const int tile = blockIdx.x / ranks;
    const int r0 = tile * ROW_TILE + rank * a.rows;
    const int nrows = max(0, min(a.rows, a.M - r0));
    const bool resident = a.nch == 1;
    const int nst1 = resident ? nrows : nrows * 2 * a.nch;
    const int nst = resident ? nrows : nrows * 3 * a.nch;
    float* gb = reinterpret_cast<float*>(sm + L.gb);
    float4* rowstat = reinterpret_cast<float4*>(sm + L.stats);
    float* red = reinterpret_cast<float*>(sm + L.red);
    int buf = 0;
    if (resident) copy_gb(a, gb, t, nt);
    for (int j = 0; j + 1 < a.ring; ++j)
        bwd_issue<ZT>(a, L, sm, j, nst, nst1, nrows, r0, t, nt);

    float cg[UNITS][VEC], cb[UNITS][VEC], cz[UNITS][VEC];
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) cg[u][e] = cb[u][e] = cz[u][e] = 0.0f;
    Stats st{0.0f, 0.0f, 0.0f};
    float rstd = 0.0f, s1[4], s2[4];
    T* DZ = static_cast<T*>(a.dz);
    T* H = static_cast<T*>(a.h);

    // Stage j, landed: this thread's units of its z and (with_dh) dh
    // into registers, zero past the row.
    auto take = [&](int j, int k, bool with_dh, float (&x)[UNITS][VEC],
                    float (&d)[UNITS][VEC], int (&nv)[UNITS]) {
        bwd_issue<ZT>(a, L, sm, j + a.ring - 1, nst, nst1, nrows, r0, t, nt);
        cp_async_wait(a.ring - 1);
        const unsigned char* slot = sm + L.ring + (j % a.ring) * L.slot;
        const ZT* zs = reinterpret_cast<const ZT*>(slot);
        const float* ds = reinterpret_cast<const float*>(
            slot + (size_t)a.chunk * sizeof(ZT));
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            const int lc = VEC * (t + u * nt);
            nv[u] = clamp8(unit_cols(a, k, u, t, nt));
            if (nv[u] > 0) {
                load8(zs + lc, x[u]);
                if (with_dh) load8(ds + lc, d[u]);
            } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e) x[u][e] = d[u][e] = 0.0f;
            }
        }
    };

    // Statistics, the sums of dxhat and dxhat xhat, and (resident) the
    // outputs, row by row.
    for (int j = 0; j < nst1; ++j) {
        int i, k, kind;
        bwd_stage(a.nch, j, nst1, nrows, i, k, kind);
        float x[UNITS][VEC], d[UNITS][VEC];
        int nv[UNITS];
        take(j, k, kind != STATS, x, d, nv);
        if (kind != SUMS) {
            chunk_stats(x, nv, min(a.chunk, a.N - k * a.chunk), k, red, buf,
                        st);
            if (k == a.nch - 1) rstd = row_rstd(st, a.N);
        }
        if (kind == STATS) continue;
        if (k == 0) {
#pragma unroll
            for (int c = 0; c < 4; ++c) s1[c] = s2[c] = 0.0f;
        }
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            if (nv[u] == 0) continue;
            float g[VEC], b[VEC];
            unit_gb(a, gb, resident, k, VEC * (t + u * nt), nv[u], g, b);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const float xhat = (x[u][e] - st.mean) * rstd;
                const float ln = xhat * g[e] + b[e];
                const float dxhat = relu_grad(ln, d[u][e]) * g[e];
                if (e < nv[u]) {
                    s1[e & 3] += dxhat;
                    s2[e & 3] += dxhat * xhat;
                }
            }
        }
        if (k != a.nch - 1) continue;
        float m[2] = {lanes4(s1), lanes4(s2)};
        block_sum<2>(m, red, buf);
        const float inv_n = 1.0f / (float)a.N;
        const float m1 = m[0] * inv_n, m2 = m[1] * inv_n;
        if (!resident) {
            if (t == 0) rowstat[i] = make_float4(st.mean, rstd, m1, m2);
            continue;
        }
        const size_t row = (size_t)(r0 + i);
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            if (nv[u] == 0) continue;
            const int lc = VEC * (t + u * nt);
            float g[VEC], b[VEC];
            unit_gb(a, gb, true, 0, lc, nv[u], g, b);
            out_unit(x[u], d[u], g, b, nv[u], st.mean, rstd, m1, m2,
                     DZ + row * a.lddz + lc,
                     H == nullptr ? nullptr : H + row * a.ldh + lc, cg[u],
                     cb[u], cz[u]);
        }
    }
    if (resident) {
        cluster_part(a, L, sm, cg, cb, cz, 0, tile, rank, ranks, true);
        return;
    }

    // Column chunks: the outputs chunk by chunk over the block's rows.
    __syncthreads();  // rowstat
    int j = nst1;
    for (int k = 0; k < a.nch; ++k) {
#pragma unroll
        for (int u = 0; u < UNITS; ++u)
#pragma unroll
            for (int e = 0; e < VEC; ++e) cg[u][e] = cb[u][e] = cz[u][e] = 0.0f;
        for (int i = 0; i < nrows; ++i, ++j) {
            float x[UNITS][VEC], d[UNITS][VEC];
            int nv[UNITS];
            take(j, k, true, x, d, nv);
            const float4 rs = rowstat[i];
            const size_t row = (size_t)(r0 + i);
#pragma unroll
            for (int u = 0; u < UNITS; ++u) {
                if (nv[u] == 0) continue;
                const int lc = VEC * (t + u * nt);
                const size_t c = (size_t)k * a.chunk + lc;
                float g[VEC], b[VEC];
                unit_gb(a, gb, false, k, lc, nv[u], g, b);
                out_unit(x[u], d[u], g, b, nv[u], rs.x, rs.y, rs.z, rs.w,
                         DZ + row * a.lddz + c,
                         H == nullptr ? nullptr : H + row * a.ldh + c, cg[u],
                         cb[u], cz[u]);
            }
        }
        cluster_part(a, L, sm, cg, cb, cz, k, tile, rank, ranks,
                     k == a.nch - 1);
    }
    cp_async_wait(0);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool aligned(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows of n elements of es bytes at p, ld apart: 16-byte aligned starts.
bool rows_ok(const void* p, int ld, int n, int es) {
    return p == nullptr ||
           (aligned(p) && ld >= n && ((size_t)ld * es) % 16 == 0);
}

// The plan's fields into a, checked against this file's layout.
int plan_args(Args& a, int bwd, int zsize, int M, int N, int threads,
              int rows, int ring, int cluster, int smem) {
    if (M < 1 || N < 1 || threads < 32 || threads > MAX_THREADS ||
        threads % 32 != 0 || rows < 1 || ring < 2 || ring > MAX_RING)
        return (int)cudaErrorInvalidValue;
    a.M = M;
    a.N = N;
    a.chunk = VEC * UNITS * threads;
    a.nch = (N + a.chunk - 1) / a.chunk;
    a.rows = rows;
    a.ring = ring;
    if (a.nch > 1 && threads != CHUNK_THREADS)
        return (int)cudaErrorInvalidValue;
    if (bwd && (cluster < 1 || cluster > MAX_CLUSTER ||
                rows * cluster != ROW_TILE))
        return (int)cudaErrorInvalidValue;
    const Layout L = layout(bwd, zsize, a.chunk, a.nch, ring, rows);
    if (smem != L.total || smem > SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    if (!aligned(a.gamma) || !aligned(a.beta))
        return (int)cudaErrorInvalidValue;
    return 0;
}

template <typename K>
int prepare(K kernel) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
}

template <typename T>
int fwd(Args a, int threads, int smem, cudaStream_t stream) {
    auto kernel = ln_fwd_rows_kernel<T>;
    static int ready = -1;
    if (ready != 0 && (ready = prepare(kernel)) != 0) return ready;
    ln_fwd_rows_kernel<T><<<(a.M + a.rows - 1) / a.rows, threads, smem,
                            stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    return (int)e;
}

template <typename T, typename ZT>
cudaLaunchConfig_t bwd_config(const Args& a, int threads, int cluster,
                              int smem, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg;
    memset(&cfg, 0, sizeof cfg);
    cfg.gridDim = dim3(cluster * ((a.M + ROW_TILE - 1) / ROW_TILE));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <typename T, typename ZT>
int bwd(Args a, int threads, int cluster, int smem, cudaStream_t stream) {
    auto kernel = ln_bwd_rows_kernel<T, ZT>;
    static int ready = -1;
    if (ready != 0 && (ready = prepare(kernel)) != 0) return ready;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        bwd_config<T, ZT>(a, threads, cluster, smem, stream, attr);
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e == cudaSuccess) e = cudaGetLastError();
    return (int)e;
}

// Blocks of the forward per SM, or clusters of the backward on the card,
// that the runtime says fit at once.
template <typename T, typename ZT>
int occupancy(int is_bwd, int M, int threads, int cluster, int smem) {
    int n = 0;
    if (!is_bwd) {
        auto kernel = ln_fwd_rows_kernel<T>;
        if (int e = prepare(kernel)) return -e;
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, threads, smem);
        return e == cudaSuccess ? n : -(int)e;
    }
    auto kernel = ln_bwd_rows_kernel<T, ZT>;
    if (int e = prepare(kernel)) return -e;
    Args a{};
    a.M = M;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        bwd_config<T, ZT>(a, threads, cluster, smem, 0, attr);
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

// The constants ops/layernorm_rows.py plans with: 0 the rows of a
// backward partial, 1 columns a unit, 2 units a thread, 3 the largest
// block, 4 the column chunks' block, 5 the deepest ring, 6 the largest
// cluster, 7 the shared-memory limit.
int ln_rows_const(int which) {
    switch (which) {
        case 0: return ROW_TILE;
        case 1: return VEC;
        case 2: return UNITS;
        case 3: return MAX_THREADS;
        case 4: return CHUNK_THREADS;
        case 5: return MAX_RING;
        case 6: return MAX_CLUSTER;
        case 7: return SMEM_LIMIT;
        default: return -1;
    }
}

// Dynamic shared memory of a launch (bwd 0 / 1, z element bytes, block
// threads, ring slots, rows a CTA, row width).
int ln_rows_smem(int is_bwd, int zsize, int threads, int ring, int rows,
                 int N) {
    const int chunk = VEC * UNITS * threads;
    return layout(is_bwd, zsize, chunk, (N + chunk - 1) / chunk, ring, rows)
        .total;
}

// Forward: H = relu(LayerNorm(Z)) (Z f32 (M, N), row stride ldz) in bf16
// (ln_rows_fwd) or f32 (ln_rows_fwd_f32); S, when not null, the bf16
// stash of Z (bf16 only).  threads, rows, ring, smem: the plan's.
int ln_rows_fwd(const float* Z, int ldz, const float* gamma,
                const float* beta, void* H, int ldh, void* S, int lds, int M,
                int N, int threads, int rows, int ring, int smem,
                cudaStream_t stream) {
    Args a{};
    a.z = Z; a.ldz = ldz; a.gamma = gamma; a.beta = beta;
    a.h = H; a.ldh = ldh; a.s = S; a.lds = lds;
    if (int e = plan_args(a, 0, 4, M, N, threads, rows, ring, 1, smem))
        return e;
    if (!rows_ok(Z, ldz, N, 4) || H == nullptr || !rows_ok(H, ldh, N, 2) ||
        !rows_ok(S, lds, N, 2))
        return (int)cudaErrorInvalidValue;
    return fwd<bf16>(a, threads, smem, stream);
}
int ln_rows_fwd_f32(const float* Z, int ldz, const float* gamma,
                    const float* beta, void* H, int ldh, void* S, int lds,
                    int M, int N, int threads, int rows, int ring, int smem,
                    cudaStream_t stream) {
    Args a{};
    a.z = Z; a.ldz = ldz; a.gamma = gamma; a.beta = beta;
    a.h = H; a.ldh = ldh;
    if (S != nullptr) return (int)cudaErrorInvalidValue;
    if (int e = plan_args(a, 0, 4, M, N, threads, rows, ring, 1, smem))
        return e;
    if (!rows_ok(Z, ldz, N, 4) || H == nullptr || !rows_ok(H, ldh, N, 4))
        return (int)cudaErrorInvalidValue;
    return fwd<float>(a, threads, smem, stream);
}

// Backward from dh (f32 (M, N), row stride lddh) and the stage's z: the
// bf16 stash (z_f32 = 0) or the f32 z (z_f32 = 1; the only z in f32).
// DZ and H (the rebuilt h; null: not written) in bf16 (ln_rows_bwd) or
// f32 (ln_rows_bwd_f32); part: (ceil(M / 128), 3 N) f32.  One launch of
// ceil(M / 128) clusters of `cluster` CTAs.
int ln_rows_bwd(const void* Z, int ldz, int z_f32, const float* DH, int lddh,
                const float* gamma, const float* beta, void* DZ, int lddz,
                void* H, int ldh, float* part, int M, int N, int threads,
                int rows, int ring, int cluster, int smem,
                cudaStream_t stream) {
    Args a{};
    a.z = Z; a.ldz = ldz; a.dh = DH; a.lddh = lddh; a.gamma = gamma;
    a.beta = beta; a.dz = DZ; a.lddz = lddz; a.h = H; a.ldh = ldh;
    a.part = part;
    const int zs = z_f32 ? 4 : 2;
    if (int e = plan_args(a, 1, zs, M, N, threads, rows, ring, cluster,
                          smem))
        return e;
    if (!rows_ok(Z, ldz, N, zs) || !rows_ok(DH, lddh, N, 4) ||
        DZ == nullptr || !rows_ok(DZ, lddz, N, 2) || !rows_ok(H, ldh, N, 2) ||
        part == nullptr)
        return (int)cudaErrorInvalidValue;
    return z_f32 ? bwd<bf16, float>(a, threads, cluster, smem, stream)
                 : bwd<bf16, bf16>(a, threads, cluster, smem, stream);
}
int ln_rows_bwd_f32(const void* Z, int ldz, int z_f32, const float* DH,
                    int lddh, const float* gamma, const float* beta,
                    void* DZ, int lddz, void* H, int ldh, float* part, int M,
                    int N, int threads, int rows, int ring, int cluster,
                    int smem, cudaStream_t stream) {
    Args a{};
    a.z = Z; a.ldz = ldz; a.dh = DH; a.lddh = lddh; a.gamma = gamma;
    a.beta = beta; a.dz = DZ; a.lddz = lddz; a.h = H; a.ldh = ldh;
    a.part = part;
    if (!z_f32) return (int)cudaErrorInvalidValue;
    if (int e = plan_args(a, 1, 4, M, N, threads, rows, ring, cluster, smem))
        return e;
    if (!rows_ok(Z, ldz, N, 4) || !rows_ok(DH, lddh, N, 4) ||
        DZ == nullptr || !rows_ok(DZ, lddz, N, 4) || !rows_ok(H, ldh, N, 4) ||
        part == nullptr)
        return (int)cudaErrorInvalidValue;
    return bwd<float, float>(a, threads, cluster, smem, stream);
}

// What the runtime says fits at once for a plan: forward blocks per SM
// (is_bwd 0), or backward clusters on the card (is_bwd 1); out_f32 and
// z_f32 pick the instantiation; a negative value is -cudaError_t.
int ln_rows_occupancy(int is_bwd, int out_f32, int z_f32, int M, int threads,
                      int cluster, int smem) {
    if (out_f32) return occupancy<float, float>(is_bwd, M, threads, cluster,
                                                smem);
    return z_f32 ? occupancy<bf16, float>(is_bwd, M, threads, cluster, smem)
                 : occupancy<bf16, bf16>(is_bwd, M, threads, cluster, smem);
}

}  // extern "C"
