// The k nearest neighbours of every row of a packed level within its own
// cloud (Point Transformer V2's pointops.knn_query), hand-written for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no PTv2.  It was added
// because no eager formula fits: a cloud's rows are known only on the
// device, and a dense distance matrix over the packed rows of level 0
// (~608k capacity rows in a batch-128 call) would be ~1.5 TB.  For the M
// rows of a level (cloud b owns rows [OFFSETS[b], OFFSETS[b + 1]), BATCH
// holds each row's cloud and B on the dummy rows past OFFSETS[B]):
//
//   OUT[r, s] = the s-th nearest row of r's cloud to r, the row itself
//               included, in (distance, row) order; -1 past the cloud's
//               row count and on every slot of a dummy row;
//   distance  = (dx*dx + dy*dy) + dz*dz in float32, d = xyz[j] - xyz[r],
//               each operation rounded on its own (__fmul_rn, __fadd_rn:
//               no contraction into FMA), as ops/knn.py's knn_plain and
//               the reference compute it, so the sets are equal.
//
// What bounds it on this card: the comparisons.  A query compares itself
// with every row of its cloud (brute force: sum over clouds of n^2, ~1.7e9
// distances at level 0 of a batch-128 call of 4k-16k points), ~10
// instructions each: ~0.6 ms at the card's full instruction rate, 3.6 ms
// as measured on an H100 (the insertions and the cloud edges' divergence
// keep it near 13% of that rate); the bytes (coordinates and cloud ids
// read once, the indices written once) are ~30 us.  The design keeps each
// comparison on chip:
//   - a block owns THREADS consecutive query rows, one a thread (usually
//     of one cloud; at a cloud's edge of two or more).  Its threads stage
//     the union of their clouds' rows in shared memory, CHUNK rows at a
//     time as float4, in row order;
//   - the CHUNK rows around the block's own come first, walked from the
//     block's first row up and then below it: a level's rows lie in an
//     order that keeps neighbours near (level 0 in input row order, which
//     the clouds' z-sort makes spatial; a pooled level by cell), so the
//     nearest rows come early and set a tight K-th distance; walked in
//     row order a query approaching its own z inserted nearly every row
//     it met (8.0 ms at level 0 of a batch-128 call, 4.8 ms with the
//     window first);
//   - each thread walks the staged rows of its own cloud (a broadcast
//     read: the warp's threads read one address) and keeps its K best in
//     registers, sorted by (distance, row): a candidate below the current
//     K-th in that order is inserted by one unrolled compare-and-swap
//     pass, so the result does not hang on the order of the walk;
//   - each thread writes its K indices once (int64).
// No atomics but the block's two integer span bounds; no host read.
//
// Host side: plain C interface (ops/knn.py loads it with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // query rows a block
constexpr int CHUNK = 2048;           // candidate rows staged at a time

// Insert (d, j) into the sorted (bd, bi), dropping the last.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int j) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
        const bool swap = d < bd[s] || (d == bd[s] && j < bi[s]);
        const float td = swap ? bd[s] : d;
        const int tj = swap ? bi[s] : j;
        bd[s] = swap ? d : bd[s];
        bi[s] = swap ? j : bi[s];
        d = td;
        j = tj;
    }
}

// Compare the query with staged row i (row c0 + i of the level).
template <int K>
__device__ __forceinline__ void compare(const float4* cand, int c0, int i,
                                        float qx, float qy, float qz,
                                        float (&bd)[K], int (&bi)[K]) {
    const float4 p = cand[i];
    const float dx = __fsub_rn(p.x, qx);
    const float dy = __fsub_rn(p.y, qy);
    const float dz = __fsub_rn(p.z, qz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    const int j = c0 + i;
    if (d < bd[K - 1] || (d == bd[K - 1] && j < bi[K - 1]))
        insert<K>(bd, bi, d, j);
}

// Stage rows [c0, c0 + n) in shared memory; each thread compares its
// query with the staged rows of its own cloud [lo, hi), from the block's
// first row r0 up, then the rows below it.
template <int K>
__device__ __forceinline__ void scan(const float* __restrict__ xyz,
                                     float4* cand, int c0, int n, int lo,
                                     int hi, int r0, float qx, float qy,
                                     float qz, float (&bd)[K], int (&bi)[K]) {
    __syncthreads();                      // the previous rows are read
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const long long j = (long long)c0 + i;
        cand[i] = make_float4(xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2],
                              0.f);
    }
    __syncthreads();
    const int a = max(lo - c0, 0), e = min(hi - c0, n);
    const int mid = min(max(r0 - c0, a), e);
    for (int i = mid; i < e; ++i) compare<K>(cand, c0, i, qx, qy, qz, bd, bi);
    for (int i = a; i < mid; ++i) compare<K>(cand, c0, i, qx, qy, qz, bd, bi);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ xyz, const long long* __restrict__ batch,
           const long long* __restrict__ offsets, long long* __restrict__ out,
           int M, int B) {
    __shared__ float4 cand[CHUNK];
    __shared__ int span[2];
    const int r0 = blockIdx.x * THREADS;
    const int r = r0 + threadIdx.x;
    if (threadIdx.x == 0) {
        span[0] = 0x7fffffff;
        span[1] = 0;
    }
    __syncthreads();
    int lo = 0, hi = 0;                   // the own cloud's rows
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (r < M) {
        const long long b = batch[r];
        if (b >= 0 && b < B) {
            lo = (int)offsets[b];
            hi = (int)offsets[b + 1];
            qx = xyz[3ll * r];
            qy = xyz[3ll * r + 1];
            qz = xyz[3ll * r + 2];
            atomicMin(&span[0], lo);
            atomicMax(&span[1], hi);
        }
    }
    __syncthreads();
    const int s0 = span[0], s1 = span[1];
    float bd[K];
    int bi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
        bd[s] = __int_as_float(0x7f800000);   // +inf
        bi[s] = -1;
    }
    if (s0 < s1) {
        // The CHUNK rows around the block's own first: near rows set a
        // tight K-th distance early (a level's rows lie in input order,
        // which the clouds' z-sort makes spatial), so the rest of the
        // span rarely inserts.  Then the span's other rows, in chunks.
        const int w0 = max(s0, min(r0 + THREADS / 2 - CHUNK / 2,
                                   s1 - CHUNK));
        const int w1 = min(w0 + CHUNK, s1);
        scan<K>(xyz, cand, w0, w1 - w0, lo, hi, r0, qx, qy, qz, bd, bi);
        for (int c0 = s0; c0 < w0; c0 += CHUNK)
            scan<K>(xyz, cand, c0, min(CHUNK, w0 - c0), lo, hi, r0, qx, qy,
                    qz, bd, bi);
        for (int c0 = w1; c0 < s1; c0 += CHUNK)
            scan<K>(xyz, cand, c0, min(CHUNK, s1 - c0), lo, hi, r0, qx, qy,
                    qz, bd, bi);
    }
    if (r < M) {
        long long* o = out + (long long)r * K;
#pragma unroll
        for (int s = 0; s < K; ++s) o[s] = bi[s];
    }
}

template <int K>
int launch(const float* xyz, const long long* batch, const long long* offsets,
           long long* out, int M, int B, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((M + THREADS - 1) / THREADS);
    knn_kernel<K><<<blocks, THREADS, 0, stream>>>(xyz, batch, offsets, out,
                                                  M, B);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The neighbour counts the library is built for, by index; -1 past the
// last.
int knn_size(int i) {
    constexpr int SIZES[] = {8, 16};
    return i >= 0 && i < 2 ? SIZES[i] : -1;
}

// OUT (M, K) int64 = the K nearest rows of each of the M rows of a packed
// level: XYZ (M, 3) float32, BATCH (M) int64 (B on dummy rows), OFFSETS
// (B + 1) int64, all contiguous.
int knn(const void* XYZ, const void* BATCH, const void* OFFSETS, void* OUT,
        int M, int B, int K, cudaStream_t stream) {
    if (M < 1 || B < 1) return (int)cudaErrorInvalidValue;
    const float* xyz = static_cast<const float*>(XYZ);
    const long long* batch = static_cast<const long long*>(BATCH);
    const long long* offsets = static_cast<const long long*>(OFFSETS);
    long long* out = static_cast<long long*>(OUT);
    switch (K) {
        case 8: return launch<8>(xyz, batch, offsets, out, M, B, stream);
        case 16: return launch<16>(xyz, batch, offsets, out, M, B, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
