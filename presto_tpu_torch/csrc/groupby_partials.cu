// Small-G grouped aggregation: the (G, K) totals of K channels over G dense
// group ids, in one launch.
//
// Replaces presto_tpu/ops/pallas_groupby.py::_kernel_factory (the Pallas
// TPU kernel launched by _pallas_partials). What it computes, for every
// group g < G and channel k < K, over rows with
//     row < min(n, *count)  &&  live[row]  &&  gid[row] == g
// (all n rows when count is null) is one of
//     ADD    sum of chan[k][row]
//     MIN    min of chan[k][row]
//     MAX    max of chan[k][row]
//     COUNT  number of such rows (reads no channel)
// written as the (G, K) totals, row-major. The TPU kernel writes per-block
// tiles that its caller folds; here the fold happens inside the launch: the
// last block to finish folds every block's tile (a ticket counter that it
// resets to 0), and a grid of one block writes the totals directly.
//
// The TPU kernel's workarounds are gone: Hopper accumulates int64 and f64
// natively, so there are no 16-bit limb channels, no hi/lo f32 split and no
// 128-lane partial tile.
//
// Bound: device-memory bytes. Each row is read once: 4 bytes of gid, 1 of
// live and 8 per data channel, against a few integer operations a byte.
// What stands between a kernel and that bound here: updates that collide
// (a few live groups take every row, so atomics on one address replay),
// too few bytes in flight, and, for small inputs, the fixed cost around a
// launch (a fold, host copies). So the accumulators stay on chip, loads
// are 16 bytes a thread (four gids, two int64 values) where the pointers
// allow, the fold is inside the launch, and two regimes, picked by the
// wrapper from (G, K), keep colliding updates off the atomics:
//
// * register tiles (G <= GB and K <= 2 KB for one of the compiled (KB, GB)
//   thread tiles of at most 32 accumulators, so G * K <= 64; TPC-H Q1's
//   6 x 6 and Q5's 25 x 2): each thread keeps its tile in registers and
//   updates it with predicated adds / mins / maxes, indexed only by
//   compile-time constants (a runtime index moves the tile to local
//   memory). No atomics. A block's channels split into up to two slices of
//   its threads, so a thread needs ~120 registers and two blocks fit on an
//   SM: one block of a 64-accumulator tile (~220 registers) left the SM too
//   few warps to overlap loads with the updates. When every channel is ADD
//   or COUNT, one compare of a row's gid serves all its channels. At block
//   end the threads store their tiles to shared memory entry by entry and
//   each warp reduces whole entries, which keeps the epilogue's code small
//   (no unrolled shuffle tree per accumulator).
// * shared-memory tiles (anything larger, up to the callers' gates of
//   about 1,024 accumulators): per-warp copies of the tile in shared memory
//   (as many as fit in 44 KB), and warp-aggregated atomics: the lanes of a
//   warp are grouped by gid (__match_any_sync), each group's values are
//   combined with shuffles, and one leader lane per group and channel
//   issues one atomic.

// f64 sums add in no fixed order (atomics, the cross-block fold): they can
// differ from a sequential sum in the last bits. Integer results are exact.
//
// The parameters travel by value in one GroupbyParams struct (1,608
// bytes, under the 4 KB kernel-parameter limit), so a launch makes no
// host-to-device copy; the struct is __grid_constant__, so indexing it at
// run time reads the parameter bank instead of copying it to local memory.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (ops/groupby_kernel.py, cuda_build.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#define MAX_K 128

// Mirrored field for field by ops/groupby_kernel.py::GroupbyParams.
struct GroupbyParams {
    const int32_t* gid;    // int32[n]
    const uint8_t* live;   // bool[n]
    const int32_t* count;  // int32[1], or null for all n rows
    void* out;             // (G, K) totals
    void* scratch;         // (blocks, G * K) block tiles; null for one block
    unsigned int* ticket;  // one counter, 0 between launches
    long long n;
    int G;
    int K;
    int aligned;           // gid and channels 16-byte, live 4-byte aligned
    int kind[MAX_K];
    const void* chan[MAX_K];  // channel k's n values; null for COUNT
};

namespace {

constexpr int KIND_ADD = 0;
constexpr int KIND_MIN = 1;
constexpr int KIND_MAX = 2;
constexpr int KIND_COUNT = 3;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_BUDGET = 44 * 1024;  // + ~2.6 KB static, under the 48 KB default
constexpr unsigned FULL = 0xffffffffu;

// the register tiles (channels, groups) of one thread, regimes 1..4; a
// block holds up to MAX_SLICES tiles' channels
constexpr int TILES[4][2] = {{4, 4}, {4, 8}, {2, 16}, {1, 32}};
constexpr int MAX_SLICES = 2;

__device__ __forceinline__ void atomic_add(long long* p, long long v) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void atomic_add(double* p, double v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_min(long long* p, long long v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_max(long long* p, long long v) { atomicMax(p, v); }

__device__ __forceinline__ void atomic_min(double* p, double v) {
    unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
    unsigned long long old = *a;
    while (v < __longlong_as_double(static_cast<long long>(old))) {
        unsigned long long seen =
            atomicCAS(a, old, static_cast<unsigned long long>(__double_as_longlong(v)));
        if (seen == old) break;
        old = seen;
    }
}
__device__ __forceinline__ void atomic_max(double* p, double v) {
    unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
    unsigned long long old = *a;
    while (v > __longlong_as_double(static_cast<long long>(old))) {
        unsigned long long seen =
            atomicCAS(a, old, static_cast<unsigned long long>(__double_as_longlong(v)));
        if (seen == old) break;
        old = seen;
    }
}

template <typename T> __device__ __forceinline__ T lowest();
template <typename T> __device__ __forceinline__ T highest();
template <> __device__ __forceinline__ long long lowest<long long>() { return (-9223372036854775807LL - 1); }
template <> __device__ __forceinline__ long long highest<long long>() { return 9223372036854775807LL; }
template <> __device__ __forceinline__ double lowest<double>() { return -__longlong_as_double(0x7ff0000000000000LL); }
template <> __device__ __forceinline__ double highest<double>() { return __longlong_as_double(0x7ff0000000000000LL); }

template <typename T>
__device__ __forceinline__ T identity(int kind) {
    if (kind == KIND_MIN) return highest<T>();
    if (kind == KIND_MAX) return lowest<T>();
    return T(0);
}

template <typename T>
__device__ __forceinline__ T combine(int kind, T a, T b) {
    if (kind == KIND_MIN) return a < b ? a : b;
    if (kind == KIND_MAX) return a > b ? a : b;
    return a + b;
}

template <typename T> struct Pair;
template <> struct Pair<long long> { using type = longlong2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ long long row_limit(const GroupbyParams& p) {
    long long limit = p.n;
    if (p.count != nullptr) {
        const long long c = static_cast<long long>(*p.count);
        if (c < limit) limit = c;
    }
    return limit < 0 ? 0 : limit;
}

// Rows 4q .. 4q+3: g[j] is the row's gid when the row is below `limit`,
// live and 0 <= gid < G, else -1. Returns whether any of the four counts.
__device__ __forceinline__ bool load_rows(const GroupbyParams& p, long long q, long long limit,
                                          int (&g)[4]) {
    const long long r0 = q * 4;
    bool lv[4];
    if (p.aligned && r0 + 4 <= limit) {
        const int4 gv = __ldg(reinterpret_cast<const int4*>(p.gid) + q);
        const uchar4 l4 = __ldg(reinterpret_cast<const uchar4*>(p.live) + q);
        g[0] = gv.x; g[1] = gv.y; g[2] = gv.z; g[3] = gv.w;
        lv[0] = l4.x; lv[1] = l4.y; lv[2] = l4.z; lv[3] = l4.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const bool in = r0 + j < limit;
            g[j] = in ? __ldg(p.gid + r0 + j) : -1;
            lv[j] = in && __ldg(p.live + r0 + j);
        }
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if (!lv[j] || g[j] < 0 || g[j] >= p.G) g[j] = -1;
        any |= g[j] >= 0;
    }
    return any;
}

// Values of rows 4q .. 4q+3 of one channel (0 past `limit`).
template <typename T>
__device__ __forceinline__ void load_vals(const GroupbyParams& p, const T* c, long long q,
                                          long long limit, T (&v)[4]) {
    const long long r0 = q * 4;
    if (p.aligned && r0 + 4 <= limit) {
        using P = typename Pair<T>::type;
        const P a = __ldg(reinterpret_cast<const P*>(c) + 2 * q);
        const P b = __ldg(reinterpret_cast<const P*>(c) + 2 * q + 1);
        v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = r0 + j < limit ? __ldg(c + r0 + j) : T(0);
    }
}

// Every block's (G, K) tile -> the totals. `tile` (shared memory, G * K
// entries, index g * K + k) holds this block's tile. One block writes it
// out; otherwise each block writes it to scratch, and the block that takes
// the last ticket folds all of them and resets the ticket.
template <typename T>
__device__ void finish(const GroupbyParams& p, const T* tile, const int* kinds) {
    __shared__ T part[THREADS];
    __shared__ bool last;
    const int K = p.K;
    const int GK = p.G * K;
    const int tid = threadIdx.x;
    T* out = static_cast<T*>(p.out);
    if (gridDim.x == 1) {
        for (int i = tid; i < GK; i += THREADS) out[i] = tile[i];
        return;
    }
    T* scratch = static_cast<T*>(p.scratch);
    for (int i = tid; i < GK; i += THREADS) {
        scratch[static_cast<long long>(blockIdx.x) * GK + i] = tile[i];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int nb = gridDim.x;
    if (GK * 2 > THREADS) {  // one thread per entry, walking every block
        for (int i = tid; i < GK; i += THREADS) {
            const int kind = kinds[i % K];
            T r = identity<T>(kind);
#pragma unroll 8
            for (int b = 0; b < nb; ++b) {
                r = combine<T>(kind, r, __ldcg(scratch + static_cast<long long>(b) * GK + i));
            }
            out[i] = r;
        }
    } else {  // `slices` threads per entry, each walking every slices-th block
        const int slices = THREADS / GK;
        const int i = tid % GK;
        const int s = tid / GK;
        const int kind = kinds[i % K];
        T r = identity<T>(kind);
        if (s < slices) {
#pragma unroll 8
            for (int b = s; b < nb; b += slices) {
                r = combine<T>(kind, r, __ldcg(scratch + static_cast<long long>(b) * GK + i));
            }
        }
        part[tid] = r;
        __syncthreads();
        if (tid < GK) {
            for (int t = 1; t < slices; ++t) r = combine<T>(kind, r, part[t * GK + tid]);
            out[tid] = r;
        }
    }
    if (tid == 0) *p.ticket = 0u;
}

__device__ __forceinline__ void load_kinds(const GroupbyParams& p, int* kinds) {
    for (int k = threadIdx.x; k < p.K; k += THREADS) kinds[k] = p.kind[k];
}

// f(integral_constant<int, I>) for I = B .. E-1: indices that are
// constants where `#pragma unroll` may leave a loop rolled (it did for the
// larger tiles, which then lived in local memory).
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    if constexpr (B < E) {
        f(std::integral_constant<int, B>());
        static_for<B + 1, E>(f);
    }
}

// acc[gg] = op(acc[gg], v[j]) where g[j] == gg, for the four rows.
template <int GB, typename T, typename Op>
__device__ __forceinline__ void update_row(T (&acc)[GB], const int (&g)[4], const T (&v)[4],
                                           Op op) {
    static_for<0, 4>([&](auto jc) {
        constexpr int j = decltype(jc)::value;
        static_for<0, GB>([&](auto gc) {
            constexpr int gg = decltype(gc)::value;
            if (g[j] == gg) acc[gg] = op(acc[gg], v[j]);
        });
    });
}

// Register regime: each thread keeps a tile acc[KB][GB] in registers,
// indexed only by compile-time constants. K channels take S = ceil(K / KB)
// slices (at most MAX_SLICES) of the block's threads: slice s accumulates
// channels s * KB .. s * KB + KB - 1 over every row, so a thread's tile
// stays small enough for two resident blocks per SM. ADD_ONLY (every
// channel ADD or COUNT, as in sums, counts and averages) loads the slice's
// four values a channel first and tests each row's group once for all of
// them; otherwise each channel takes its kind's branch. At block end every
// thread stores its live accumulators to shared memory, entry-major
// (dynamic shared memory: tile_smem_bytes), and each warp reduces whole
// entries.
template <typename T, int KB, int GB, bool ADD_ONLY>
__global__ void __launch_bounds__(THREADS, 2)
groupby_tile_kernel(const __grid_constant__ GroupbyParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* lanes = reinterpret_cast<T*>(smem_raw);  // [G * K][slice threads]
    __shared__ T tile[MAX_SLICES * KB * GB];
    __shared__ int kinds[MAX_K];
    load_kinds(p, kinds);
    const int K = p.K;
    const int G = p.G;
    const int slices = (K + KB - 1) / KB;
    const int per_slice = THREADS / slices;  // threads; whole warps
    const int t = threadIdx.x % per_slice;
    const int k0 = threadIdx.x / per_slice * KB;  // the slice's first channel

    T acc[KB][GB];
    static_for<0, KB>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        const T id = identity<T>(k0 + k < K ? p.kind[k0 + k] : KIND_ADD);
        static_for<0, GB>([&](auto gc) { acc[k][decltype(gc)::value] = id; });
    });

    const long long limit = row_limit(p);
    const long long nq = (limit + 3) / 4;
    const long long stride = static_cast<long long>(gridDim.x) * per_slice;
    for (long long q = static_cast<long long>(blockIdx.x) * per_slice + t; q < nq; q += stride) {
        // no skip of quads whose rows are all dead: the channel loads must
        // not wait for the gid and live loads (a quad of int64 values is
        // one 32-byte sector, read whole in any case)
        int g[4];
        load_rows(p, q, limit, g);
        if constexpr (ADD_ONLY) {
            // channels past K add zeros: cheaper than a guard on each add
            T v[KB][4];
            static_for<0, KB>([&](auto kc) {
                constexpr int k = decltype(kc)::value;
                v[k][0] = v[k][1] = v[k][2] = v[k][3] = k0 + k < K ? T(1) : T(0);
                if (k0 + k < K && p.kind[k0 + k] != KIND_COUNT) {
                    load_vals<T>(p, static_cast<const T*>(p.chan[k0 + k]), q, limit, v[k]);
                }
            });
            static_for<0, 4>([&](auto jc) {
                constexpr int j = decltype(jc)::value;
                static_for<0, GB>([&](auto gc) {
                    constexpr int gg = decltype(gc)::value;
                    if (g[j] == gg) {
                        static_for<0, KB>([&](auto kc) {
                            constexpr int k = decltype(kc)::value;
                            acc[k][gg] += v[k][j];
                        });
                    }
                });
            });
        } else {
            static_for<0, KB>([&](auto kc) {
                constexpr int k = decltype(kc)::value;
                if (k0 + k < K) {
                    const int kind = p.kind[k0 + k];
                    T v[4] = {T(1), T(1), T(1), T(1)};
                    if (kind != KIND_COUNT) {
                        load_vals<T>(p, static_cast<const T*>(p.chan[k0 + k]), q, limit, v);
                    }
                    if (kind == KIND_MIN) {
                        update_row<GB>(acc[k], g, v, [](T a, T b) { return b < a ? b : a; });
                    } else if (kind == KIND_MAX) {
                        update_row<GB>(acc[k], g, v, [](T a, T b) { return b > a ? b : a; });
                    } else {
                        update_row<GB>(acc[k], g, v, [](T a, T b) { return a + b; });
                    }
                }
            });
        }
    }

    static_for<0, KB>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        static_for<0, GB>([&](auto gc) {
            constexpr int gg = decltype(gc)::value;
            if (k0 + k < K && gg < G) lanes[(gg * K + k0 + k) * per_slice + t] = acc[k][gg];
        });
    });
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int GK = G * K;
    for (int i = threadIdx.x >> 5; i < GK; i += WARPS) {
        const int kind = kinds[i % K];
        const T* row = lanes + i * per_slice;
        T x = row[lane];
        for (int u = lane + 32; u < per_slice; u += 32) x = combine<T>(kind, x, row[u]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            x = combine<T>(kind, x, __shfl_xor_sync(FULL, x, off));
        }
        if (lane == 0) tile[i] = x;
    }
    __syncthreads();
    finish<T>(p, tile, kinds);
}

template <typename T, int KB, int GB>
constexpr int tile_smem_bytes() {
    return KB * GB * THREADS * static_cast<int>(sizeof(T));
}

// Launches (or, with `occupancy`, sizes) one register-tile instance. Its
// dynamic shared memory passes the 48 KB default, so the limit is raised
// once per instance first.
template <typename T, int KB, int GB, bool ADD_ONLY>
cudaError_t tile_launch(const GroupbyParams& p, int blocks, cudaStream_t stream, int* occupancy) {
    auto* kernel = groupby_tile_kernel<T, KB, GB, ADD_ONLY>;
    constexpr int smem = tile_smem_bytes<T, KB, GB>();
    static cudaError_t raised =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (raised != cudaSuccess) return raised;
    if (occupancy != nullptr) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, THREADS, smem);
    }
    kernel<<<blocks, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// The ADD_ONLY instance when every channel is ADD or COUNT (float64 takes
// nothing else), the kind-branching one otherwise; `occupancy` gets the
// smaller of the two instances' resident blocks.
template <typename T, int KB, int GB>
cudaError_t tile_dispatch(const GroupbyParams& p, bool add_only, int blocks, cudaStream_t stream,
                          int* occupancy) {
    constexpr bool f64 = std::is_same<T, double>::value;
    if (occupancy != nullptr) {
        cudaError_t rc = tile_launch<T, KB, GB, true>(p, blocks, stream, occupancy);
        if constexpr (!f64) {
            int general = 0;
            if (rc == cudaSuccess) rc = tile_launch<T, KB, GB, false>(p, blocks, stream, &general);
            if (general < *occupancy) *occupancy = general;
        }
        return rc;
    }
    if (add_only) return tile_launch<T, KB, GB, true>(p, blocks, stream, nullptr);
    if constexpr (f64) {
        return cudaErrorInvalidValue;
    } else {
        return tile_launch<T, KB, GB, false>(p, blocks, stream, nullptr);
    }
}

// Combines `v` over the lanes of `peers` (this lane's gid group); the
// group's leader (its lowest lane) returns the total. Every lane of the
// warp calls it together; `alive` is false for rows that count nowhere.
template <typename T>
__device__ __forceinline__ T peer_total(int kind, T v, unsigned peers, bool alive, int lane) {
    if (__all_sync(FULL, alive && peers == FULL)) {  // one group: a shuffle tree
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            v = combine<T>(kind, v, __shfl_xor_sync(FULL, v, off));
        }
        return v;
    }
    const bool leader = alive && (__ffs(peers) - 1) == lane;
    unsigned rest = leader ? (peers & (peers - 1)) : 0u;  // the other members
    T x = v;
    while (__any_sync(FULL, rest != 0u)) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const T y = __shfl_sync(FULL, v, src);
        if (rest) {
            x = combine<T>(kind, x, y);
            rest &= rest - 1;
        }
    }
    return x;
}

// Shared-memory regime: `copies` per-warp copies of the (G, K) tile in
// dynamic shared memory, warp-aggregated atomics.
template <typename T>
__global__ void __launch_bounds__(THREADS)
groupby_atomic_kernel(const __grid_constant__ GroupbyParams p, int copies) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* acc = reinterpret_cast<T*>(smem_raw);
    __shared__ int kinds[MAX_K];
    load_kinds(p, kinds);
    __syncthreads();
    const int K = p.K;
    const int GK = p.G * K;
    for (int i = threadIdx.x; i < copies * GK; i += THREADS) acc[i] = identity<T>(kinds[i % K]);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T* mine = acc + (warp % copies) * GK;
    const long long limit = row_limit(p);
    const long long nq = (limit + 3) / 4;
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    // warp-uniform loop: every lane runs every step, so the warp stays whole
    for (long long base = static_cast<long long>(blockIdx.x) * THREADS + warp * 32; base < nq;
         base += stride) {
        const long long q = base + lane;
        int g[4] = {-1, -1, -1, -1};
        const bool any = q < nq && load_rows(p, q, limit, g);
        if (!__any_sync(FULL, any)) continue;
        unsigned peers[4];
        bool lead[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            peers[j] = __match_any_sync(FULL, g[j]);
            lead[j] = g[j] >= 0 && (__ffs(peers[j]) - 1) == lane;
        }
        for (int k = 0; k < K; ++k) {
            const int kind = kinds[k];
            T v[4] = {T(1), T(1), T(1), T(1)};
            if (kind != KIND_COUNT) {
                if (any) {
                    load_vals<T>(p, static_cast<const T*>(p.chan[k]), q, limit, v);
                } else {
                    v[0] = v[1] = v[2] = v[3] = T(0);
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const T x = peer_total<T>(kind, v[j], peers[j], g[j] >= 0, lane);
                if (lead[j]) {
                    T* a = mine + g[j] * K + k;
                    if (kind == KIND_MIN) {
                        atomic_min(a, x);
                    } else if (kind == KIND_MAX) {
                        atomic_max(a, x);
                    } else {
                        atomic_add(a, x);
                    }
                }
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < GK; i += THREADS) {
        const int kind = kinds[i % K];
        T r = acc[i];
        for (int c = 1; c < copies; ++c) r = combine<T>(kind, r, acc[c * GK + i]);
        acc[i] = r;
    }
    __syncthreads();
    finish<T>(p, acc, kinds);
}

// Launches (or, with `occupancy`, sizes) the shared-memory regime.
template <typename T>
cudaError_t atomic_launch(const GroupbyParams& p, int blocks, cudaStream_t stream,
                          int* occupancy) {
    const long long per_copy = static_cast<long long>(p.G) * p.K * sizeof(T);
    if (per_copy > SMEM_BUDGET) return cudaErrorInvalidValue;
    const long long fit = SMEM_BUDGET / per_copy;
    const int copies = static_cast<int>(fit < WARPS ? fit : WARPS);
    const size_t smem = static_cast<size_t>(copies * per_copy);
    if (occupancy != nullptr) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, groupby_atomic_kernel<T>,
                                                             THREADS, smem);
    }
    groupby_atomic_kernel<T><<<blocks, THREADS, smem, stream>>>(p, copies);
    return cudaGetLastError();
}

// One regime's kernel for p's (G, K) and kinds: launched, or with
// `occupancy` its resident blocks per SM.
template <typename T>
cudaError_t dispatch(const GroupbyParams& p, int regime, int blocks, cudaStream_t stream,
                     int* occupancy) {
    if (regime < 0 || regime > 4 ||
        (regime > 0 &&
         (p.K > MAX_SLICES * TILES[regime - 1][0] || p.G > TILES[regime - 1][1]))) {
        return cudaErrorInvalidValue;
    }
    bool add_only = true;
    for (int k = 0; k < p.K; ++k) add_only &= p.kind[k] == KIND_ADD || p.kind[k] == KIND_COUNT;
    switch (regime) {
        case 0: return atomic_launch<T>(p, blocks, stream, occupancy);
        case 1: return tile_dispatch<T, 4, 4>(p, add_only, blocks, stream, occupancy);
        case 2: return tile_dispatch<T, 4, 8>(p, add_only, blocks, stream, occupancy);
        case 3: return tile_dispatch<T, 2, 16>(p, add_only, blocks, stream, occupancy);
        default: return tile_dispatch<T, 1, 32>(p, add_only, blocks, stream, occupancy);
    }
}

}  // namespace

extern "C" {

// *p is copied into the launch; regime 0 = shared-memory tiles, 1..4 =
// the register tiles of TILES; f64 selects float64 channels and totals
// (int64 otherwise). Returns the launch's cudaError_t (0 = success).
int groupby_totals_launch(const GroupbyParams* p, int f64, int regime, int blocks,
                          void* stream) {
    if (p->K < 1 || p->K > MAX_K || p->G < 1 || p->n < 1 || blocks < 1 ||
        (blocks > 1 && (p->scratch == nullptr || p->ticket == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(f64 ? dispatch<double>(*p, regime, blocks, s, nullptr)
                                : dispatch<long long>(*p, regime, blocks, s, nullptr));
}

// Resident blocks per SM of one regime's kernel at (G, K), into *out.
int groupby_blocks_per_sm(int f64, int regime, int G, int K, int* out) {
    if (K < 1 || K > MAX_K || G < 1) return static_cast<int>(cudaErrorInvalidValue);
    GroupbyParams p = {};
    p.G = G;
    p.K = K;
    return static_cast<int>(f64 ? dispatch<double>(p, regime, 0, nullptr, out)
                                : dispatch<long long>(p, regime, 0, nullptr, out));
}

// sizeof(GroupbyParams) and the offsets of its fields, in declaration
// order, into out[0..12]; returns the number written.
int groupby_params_layout(long long* out) {
    const long long v[] = {
        sizeof(GroupbyParams),
        offsetof(GroupbyParams, gid), offsetof(GroupbyParams, live),
        offsetof(GroupbyParams, count), offsetof(GroupbyParams, out),
        offsetof(GroupbyParams, scratch), offsetof(GroupbyParams, ticket),
        offsetof(GroupbyParams, n), offsetof(GroupbyParams, G), offsetof(GroupbyParams, K),
        offsetof(GroupbyParams, aligned), offsetof(GroupbyParams, kind),
        offsetof(GroupbyParams, chan),
    };
    for (int i = 0; i < 13; ++i) out[i] = v[i];
    return 13;
}

}  // extern "C"
