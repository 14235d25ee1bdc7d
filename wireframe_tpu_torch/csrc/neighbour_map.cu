// Submanifold neighbour map of one level of packed rows (Point Transformer
// V3's stem and xCPE convs read it), hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no PTv3.  It was added
// because the eager form (ops/voxel.py's neighbour_map_plain: every (row,
// offset) query spread into a Morton code by ~16 int64 passes, then a
// binary search over the sorted keys, a gather, a compare and a where)
// spent ~46 ms of a ~169 ms batch-128 call.  For the M packed rows of a
// level (KEY = batch << 48 | morton(GRID), DUMMY_KEY on the invalid rows
// that the level sorts last) and K = SIZE^3 offsets (dx, dy, dz) over
// [-SIZE/2, SIZE/2]^3 in lexicographic order, dz fastest:
//
//   NBR[r, o] = the row whose key is batch[r] << 48 | morton(grid[r] + o),
//               M where there is none, where grid[r] + o leaves
//               [0, 2^16)^3, or where row r is not valid;
//   PAIRS     = the number of (r, o) that found a row.
//
// What bounds it on this card: bytes.  The map is written once, M K 8
// bytes (~0.8 GB for the six maps of a batch-128 call), and each level's
// key, grid, batch and valid are read once (41 bytes a row): ~0.26 ms a
// call at 3.35 TB/s.  The design turns the lookups into ~1.3 random reads
// from L2 a query and keeps the map's stores coalesced:
//   - nbr_table_kernel inserts every valid row into an open-addressing
//     hash table of int32 slots (row + 1; 0 empty), at least 2M slots, a
//     power of two (2^21 at level 0: 8 MB, which stays in the 50 MB L2
//     beside the 4.9 MB of keys).  Insertion by integer atomicCAS, linear
//     probing from a multiplicative hash of the key; the level's keys are
//     distinct, and an equal key would keep the lowest row (atomicMin),
//     as the binary search finds the leftmost.  Insertion order moves
//     where a key lands, never what a lookup answers.
//   - nbr_query_kernel<SIZE>: a block owns a tile of TILE rows.  It first
//     stages each row's coordinates, their spread (Morton) bits, batch
//     << 48 and flags in shared memory; then its threads walk the tile's
//     TILE x K queries in store order, so a warp writes 32 consecutive
//     int64.  A query adds the offset in the spread form (dilated
//     integer addition: three adds and masks instead of re-spreading),
//     range-tests the plain coordinates, and probes the table; a slot is
//     confirmed by reading the row's key.  At level 0's load (~0.21 of
//     the slots) a lookup reads ~1.1 slots (hit) to ~1.3 (miss), mostly
//     in one sector.
//   - Hits are summed a warp (__reduce_add_sync), a block in shared
//     memory, then one integer atomicAdd a block into PAIRS.
// The entry point zeroes PAIRS and the table with one cudaMemsetAsync; no
// float atomics, no host read.  The table is built per map (the level-0
// table twice, for the stem's size 5 and the xCPE's size 3): a build is a
// few microseconds against the map's writes.
//
// Host side: plain C interface (ops/voxel.py loads it with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int THREADS = 256;
constexpr int TILE = 64;              // rows a query block
constexpr int COORD_BITS = 16;
constexpr int BATCH_SHIFT = 3 * COORD_BITS;
constexpr u64 HASH_MUL = 0x9E3779B97F4A7C15ull;   // 2^64 / golden ratio
constexpr u64 DILATED = 0x1249249249249249ull;    // every third bit

struct Params {
    const long long* key;         // (M,)
    const long long* grid;        // (M, 3)
    const long long* batch;       // (M,)
    const unsigned char* valid;   // (M,) bool
    long long* nbr;               // (M, K)
    u64* pairs;                   // one int64
    int* table;                   // slots: row + 1, 0 empty
    int M;
    unsigned mask;                // slots - 1
    int shift;                    // 64 - log2(slots)
};

// One row of a query tile, staged once for its K queries.
struct Row {
    long long g[3];               // grid coordinates
    u64 s[3];                     // their spread bits (morton before shifts)
    u64 base;                     // batch << 48
    int valid;
    int direct;                   // every coordinate in [0, 2^16)
};

// A 16-bit integer to every third bit (ops/voxel.py's _SPREAD).
__device__ __forceinline__ u64 spread(u64 v) {
    v &= 0xFFFF;
    v = (v | (v << 32)) & 0x1F00000000FFFFull;
    v = (v | (v << 16)) & 0x1F0000FF0000FFull;
    v = (v | (v << 8)) & 0x100F00F00F00F00Full;
    v = (v | (v << 4)) & 0x10C30C30C30C30C3ull;
    v = (v | (v << 2)) & 0x1249249249249249ull;
    return v;
}

__device__ __forceinline__ u64 morton(u64 x, u64 y, u64 z) {
    return (spread(x) << 2) | (spread(y) << 1) | spread(z);
}

// spread(c + d) from s = spread(c), for |d| <= 2 and c + d in
// [0, 2^16): dilated addition, the carry bridging the holes.
__device__ __forceinline__ u64 dilated_add(u64 s, int d) {
    const u64 step = d == 2 || d == -2 ? 8ull : (u64)(d < 0 ? -d : d);
    return d >= 0 ? ((s | ~DILATED) + step) & DILATED
                  : (s - step) & DILATED;
}

__device__ __forceinline__ unsigned slot_of(u64 k, int shift) {
    return (unsigned)((k * HASH_MUL) >> shift);
}

__global__ void __launch_bounds__(THREADS) nbr_table_kernel(const Params p) {
    const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (r >= p.M || !p.valid[r]) return;
    const u64 k = (u64)p.key[r];
    unsigned h = slot_of(k, p.shift);
    for (;;) {
        const int prev = atomicCAS(p.table + h, 0, (int)(r + 1));
        if (prev == 0) return;
        if ((u64)p.key[prev - 1] == k) {
            atomicMin(p.table + h, (int)(r + 1));
            return;
        }
        h = (h + 1) & p.mask;
    }
}

// The row whose key is q, or M.
__device__ __forceinline__ long long lookup(const Params& p, u64 q) {
    unsigned h = slot_of(q, p.shift);
    for (;;) {
        const int s = __ldg(p.table + h);
        if (s == 0) return p.M;
        if ((u64)__ldg(p.key + s - 1) == q) return s - 1;
        h = (h + 1) & p.mask;
    }
}

template <int SIZE>
__global__ void __launch_bounds__(THREADS) nbr_query_kernel(const Params p) {
    constexpr int K = SIZE * SIZE * SIZE;
    constexpr int R = SIZE / 2;
    __shared__ Row rows[TILE];
    __shared__ unsigned block_hits;
    const long long r0 = (long long)blockIdx.x * TILE;
    const int n = (int)min((long long)TILE, (long long)p.M - r0);
    if (threadIdx.x == 0) block_hits = 0;
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const long long r = r0 + i;
        Row w;
        int direct = 1;
        for (int a = 0; a < 3; ++a) {
            w.g[a] = p.grid[3 * r + a];
            w.s[a] = spread((u64)w.g[a]);
            direct &= (u64)w.g[a] < (1ull << COORD_BITS);
        }
        w.base = (u64)p.batch[r] << BATCH_SHIFT;
        w.valid = p.valid[r] != 0;
        w.direct = direct;
        rows[i] = w;
    }
    __syncthreads();
    unsigned hits = 0;
    long long* out = p.nbr + r0 * K;
    for (int idx = threadIdx.x; idx < n * K; idx += THREADS) {
        const int i = idx / K;
        const int o = idx - i * K;
        const Row& w = rows[i];
        long long found = p.M;
        if (w.valid) {
            const int d[3] = {o / (SIZE * SIZE) - R, (o / SIZE) % SIZE - R,
                              o % SIZE - R};
            const long long x = w.g[0] + d[0], y = w.g[1] + d[1],
                            z = w.g[2] + d[2];
            constexpr u64 LIMIT = 1ull << COORD_BITS;
            if ((u64)x < LIMIT && (u64)y < LIMIT && (u64)z < LIMIT) {
                const u64 code =
                    w.direct ? (dilated_add(w.s[0], d[0]) << 2) |
                                   (dilated_add(w.s[1], d[1]) << 1) |
                                   dilated_add(w.s[2], d[2])
                             : morton((u64)x, (u64)y, (u64)z);
                found = lookup(p, w.base | code);
                hits += found != p.M;
            }
        }
        out[idx] = found;
    }
    hits = __reduce_add_sync(0xffffffffu, hits);
    if ((threadIdx.x & 31) == 0 && hits) atomicAdd(&block_hits, hits);
    __syncthreads();
    if (threadIdx.x == 0 && block_hits) atomicAdd(p.pairs, (u64)block_hits);
}

template <int SIZE>
int query(const Params& p, cudaStream_t stream) {
    const long long blocks = ((long long)p.M + TILE - 1) / TILE;
    nbr_query_kernel<SIZE><<<(unsigned)blocks, THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The map sizes the library is built for, by index; -1 past the last.
int nbr_map_size(int i) {
    constexpr int SIZES[] = {3, 5};
    return i >= 0 && i < 2 ? SIZES[i] : -1;
}

// NBR (M, SIZE^3) int64 = the neighbour map of M packed rows: KEY (M)
// int64, GRID (M, 3) int64, BATCH (M) int64, VALID (M) bool, all
// contiguous.  WORK: 8 + 4 * 2^SLOTS_LOG2 bytes, the pairs count (int64)
// then the table, zeroed here; 2^SLOTS_LOG2 > the valid rows.
int neighbour_map(const void* KEY, const void* GRID, const void* BATCH,
                  const void* VALID, void* NBR, void* WORK, int M, int SIZE,
                  int SLOTS_LOG2, cudaStream_t stream) {
    if (M < 1 || SLOTS_LOG2 < 1 || SLOTS_LOG2 > 31 ||
        (1ll << SLOTS_LOG2) <= (long long)M)
        return (int)cudaErrorInvalidValue;
    if (SIZE != 3 && SIZE != 5) return (int)cudaErrorInvalidValue;
    Params p;
    p.key = static_cast<const long long*>(KEY);
    p.grid = static_cast<const long long*>(GRID);
    p.batch = static_cast<const long long*>(BATCH);
    p.valid = static_cast<const unsigned char*>(VALID);
    p.nbr = static_cast<long long*>(NBR);
    p.pairs = static_cast<u64*>(WORK);
    p.table = reinterpret_cast<int*>(static_cast<u64*>(WORK) + 1);
    p.M = M;
    p.mask = (unsigned)((1ull << SLOTS_LOG2) - 1);
    p.shift = 64 - SLOTS_LOG2;
    cudaError_t e = cudaMemsetAsync(
        WORK, 0, 8 + 4 * ((size_t)1 << SLOTS_LOG2), stream);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = ((long long)M + THREADS - 1) / THREADS;
    nbr_table_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    return SIZE == 3 ? query<3>(p, stream) : query<5>(p, stream);
}

}  // extern "C"
