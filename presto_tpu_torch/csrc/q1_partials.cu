// Fused TPC-H Q1 aggregation: one pass over lineitem, every Q1 aggregate of
// the 6 (returnflag, linestatus) groups, folded and normalized in one launch.
//
// Replaces presto_tpu/ops/pallas_agg.py::_kernel (the Pallas TPU kernel
// launched by q1_partial_sums) and the fold of its tiles (`combine`). What
// it computes, over rows with
//     row < min(n, *count)  &&  ship[row] <= *cutoff
//     &&  0 <= g < 6,  g = rf[row] * 2 + ls[row]   (in 64-bit arithmetic)
// is, per group g, eight int64 channels:
//     0 count   1 qty   2 price   3 disc
//     4, 5  disc_price = price * (100 - disc)            as hi and lo lanes
//     6, 7  charge     = disc_price * (100 + tax)        as hi and lo lanes
// where a lane pair is v >> 32 (arithmetic) and v & 0xFFFFFFFF, the radix
// 2^32 layout of ops/decimal128.py. Every channel is summed modulo 2^64, as
// the plain version's int64 index_add_ does, so the two agree bit for bit
// on any input. The launch writes OUT_WORDS int64 (ops/agg_kernel.py reads
// them as views): count, sum_qty, sum_price and sum_disc (6 each, group
// order), then sum_disc_price and sum_charge as (6, 2) lane pairs,
// normalized (decimal128.dnorm: lo's arithmetic shift carried into hi).
//
// Exactness: per row, disc_price and charge fit in int64 for any int32 price
// and DECIMAL(4,2) disc and tax (|charge| < 2^31 * 2^14.1 * 2^14.1 < 2^63),
// but a group's sum of charge passes 2^63 near SF 100, so they are never
// summed as one int64: the hi lanes stay below 2^27 a row and the lo lanes
// below 2^32, so their int64 sums are exact for any row count below 2^31.
//
// Bound: device-memory bytes, 44 a row (four int64 and three int32
// columns). What stood between the first version and that bound: a fold,
// two normalizations and stacks after the launch (nine more launches a
// call); one row a thread per step, its decimals loaded only after the
// filter's branch (two dependent trips to memory); and 6 x 8 int64
// accumulators in registers, which left room for one block per SM and cost
// 48 predicated 64-bit adds a row. So here:
// * each lane takes 2 * PAIRS rows a step and issues every load of them
//   before the filter decides (the filter predicates the adds): 16-byte
//   loads of two int64 values, 8-byte loads of two int32 values, each
//   warp-wide load one contiguous run; the wrapper picks the one-row-load
//   instance when a column's pointer is not aligned for them, and the last,
//   partial step of a warp always takes one-row loads, so nothing is read
//   past min(n, count);
// * the accumulators live in a per-thread slab of shared memory, entry
//   (g * 8 + k) of thread t at [g * 8 + k][t]: a row costs 8 read-modify-
//   writes of its own group's entries (a warp's accesses fall in distinct
//   banks whatever the groups), registers stay free for loads in flight, and
//   two blocks fit on an SM (96 KB of slab each);
// * at block end each warp reduces whole entries of the slab into the
//   block's (6, 8) tile; blocks write their tiles to scratch, and the block
//   that takes the last ticket folds them, normalizes the lanes, writes the
//   result and resets the ticket (one block writes its tile directly).
//
// The parameters travel by value in one Q1Params struct (__grid_constant__),
// so a launch copies nothing between host and device.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (ops/agg_kernel.py, cuda_build.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

// Mirrored field for field by ops/agg_kernel.py::Q1Params.
struct Q1Params {
    const long long* qty;    // int64[n]
    const long long* price;  // int64[n]
    const long long* disc;   // int64[n]
    const long long* tax;    // int64[n]
    const int32_t* rf;       // int32[n]
    const int32_t* ls;       // int32[n]
    const int32_t* ship;     // int32[n]
    const int32_t* count;    // int32[1]
    const int32_t* cutoff;   // int32[1]
    long long* out;          // OUT_WORDS int64
    long long* scratch;      // (blocks, G * K) block tiles; null for one block
    unsigned int* ticket;    // one counter, 0 between launches
    long long n;
};

namespace {

constexpr int G = 6;
constexpr int K = 8;
constexpr int GK = G * K;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAIRS = 2;               // pairs of adjacent rows a lane takes a step
constexpr int ROWS = 2 * PAIRS;        // rows a lane takes a step
constexpr int WARP_ROWS = 64 * PAIRS;  // rows a warp takes a step
constexpr int BLOCK_ROWS = WARPS * WARP_ROWS;  // = ops/agg_kernel.py BLOCK_ROWS
constexpr int SLAB_BYTES = GK * THREADS * static_cast<int>(sizeof(unsigned long long));
constexpr unsigned long long MASK32 = 0xFFFFFFFFULL;
constexpr unsigned FULL = 0xffffffffu;

// f(integral_constant<int, I>) for I = B .. E-1: array indices that are
// constants, so the per-lane row arrays stay in registers.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    if constexpr (B < E) {
        f(std::integral_constant<int, B>());
        static_for<B + 1, E>(f);
    }
}

__device__ __forceinline__ void load2(const long long* c, long long r, long long& a,
                                      long long& b) {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(c + r));
    a = v.x;
    b = v.y;
}

__device__ __forceinline__ void load2(const int32_t* c, long long r, int& a, int& b) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(c + r));
    a = v.x;
    b = v.y;
}

// The (6, 8) tile -> the OUT_WORDS result, one entry (or lane pair) a thread.
__device__ __forceinline__ void write_out(long long* out, const unsigned long long* tile,
                                          int tid) {
    if (tid < 4 * G) {  // count, qty, price, disc: field-major
        out[tid] = static_cast<long long>(tile[(tid % G) * K + tid / G]);
    } else if (tid < 6 * G) {  // disc_price, then charge: (6, 2) lane pairs
        const int c = (tid - 4 * G) / G;
        const int g = (tid - 4 * G) % G;
        const long long hi = static_cast<long long>(tile[g * K + 4 + 2 * c]);
        const long long lo = static_cast<long long>(tile[g * K + 5 + 2 * c]);
        long long* o = out + 4 * G + c * 2 * G + 2 * g;
        o[0] = static_cast<long long>(static_cast<unsigned long long>(hi) +
                                      static_cast<unsigned long long>(lo >> 32));
        o[1] = static_cast<long long>(static_cast<unsigned long long>(lo) & MASK32);
    }
}

// VEC: every int64 column 16-byte and every int32 column 8-byte aligned, so
// full steps take the paired loads.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
q1_partials_kernel(const __grid_constant__ Q1Params p) {
    extern __shared__ __align__(16) unsigned long long slab[];  // [g * K + k][THREADS]
    __shared__ unsigned long long tile[GK];
    __shared__ bool last;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    unsigned long long* mine = slab + tid;
    for (int i = 0; i < GK; ++i) mine[i * THREADS] = 0;  // only this thread's column

    long long limit = static_cast<long long>(*p.count);
    if (limit > p.n) limit = p.n;
    const int cut = *p.cutoff;
    const long long step = static_cast<long long>(gridDim.x) * BLOCK_ROWS;
    // lane's rows of a step: base + 64 j + 2 lane + {0, 1}, j < PAIRS
    for (long long base = static_cast<long long>(blockIdx.x) * BLOCK_ROWS + warp * WARP_ROWS;
         base < limit; base += step) {
        long long q[ROWS], pr[ROWS], d[ROWS], t[ROWS];
        int rf[ROWS], ls[ROWS], sh[ROWS];
        bool in[ROWS];
        if (VEC && base + WARP_ROWS <= limit) {
            static_for<0, PAIRS>([&](auto jc) {
                constexpr int j = decltype(jc)::value;
                const long long r = base + 64 * j + 2 * lane;
                load2(p.qty, r, q[2 * j], q[2 * j + 1]);
                load2(p.price, r, pr[2 * j], pr[2 * j + 1]);
                load2(p.disc, r, d[2 * j], d[2 * j + 1]);
                load2(p.tax, r, t[2 * j], t[2 * j + 1]);
                load2(p.rf, r, rf[2 * j], rf[2 * j + 1]);
                load2(p.ls, r, ls[2 * j], ls[2 * j + 1]);
                load2(p.ship, r, sh[2 * j], sh[2 * j + 1]);
                in[2 * j] = in[2 * j + 1] = true;
            });
        } else {
            static_for<0, ROWS>([&](auto ic) {
                constexpr int i = decltype(ic)::value;
                const long long r = base + 64 * (i / 2) + 2 * lane + (i % 2);
                in[i] = r < limit;
                q[i] = in[i] ? __ldg(p.qty + r) : 0;
                pr[i] = in[i] ? __ldg(p.price + r) : 0;
                d[i] = in[i] ? __ldg(p.disc + r) : 0;
                t[i] = in[i] ? __ldg(p.tax + r) : 0;
                rf[i] = in[i] ? __ldg(p.rf + r) : 0;
                ls[i] = in[i] ? __ldg(p.ls + r) : 0;
                sh[i] = in[i] ? __ldg(p.ship + r) : 0;
            });
        }
        static_for<0, ROWS>([&](auto ic) {
            constexpr int i = decltype(ic)::value;
            const long long g = 2LL * rf[i] + ls[i];
            if (in[i] && sh[i] <= cut && g >= 0 && g < G) {
                // modulo-2^64 products and sums, as torch's int64 arithmetic
                const unsigned long long dp = static_cast<unsigned long long>(pr[i]) *
                                              (100ULL - static_cast<unsigned long long>(d[i]));
                const unsigned long long ch = dp * (100ULL + static_cast<unsigned long long>(t[i]));
                unsigned long long* s = mine + static_cast<int>(g) * (K * THREADS);
                s[0 * THREADS] += 1ULL;
                s[1 * THREADS] += static_cast<unsigned long long>(q[i]);
                s[2 * THREADS] += static_cast<unsigned long long>(pr[i]);
                s[3 * THREADS] += static_cast<unsigned long long>(d[i]);
                s[4 * THREADS] += static_cast<unsigned long long>(static_cast<long long>(dp) >> 32);
                s[5 * THREADS] += dp & MASK32;
                s[6 * THREADS] += static_cast<unsigned long long>(static_cast<long long>(ch) >> 32);
                s[7 * THREADS] += ch & MASK32;
            }
        });
    }

    // the block's tile: each warp reduces whole entries of the slab
    __syncthreads();
    for (int e = warp; e < GK; e += WARPS) {
        const unsigned long long* row = slab + e * THREADS;
        unsigned long long x = 0;
#pragma unroll
        for (int u = 0; u < THREADS / 32; ++u) x += row[u * 32 + lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
        if (lane == 0) tile[e] = x;
    }
    __syncthreads();

    if (gridDim.x > 1) {
        unsigned long long* scratch = reinterpret_cast<unsigned long long*>(p.scratch);
        if (tid < GK) scratch[static_cast<long long>(blockIdx.x) * GK + tid] = tile[tid];
        __threadfence();
        __syncthreads();
        if (tid == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
        __syncthreads();
        if (!last) return;
        __threadfence();
        // SLICES threads an entry, each walking every SLICES-th block; the
        // slab (read in full above) holds their partial sums
        constexpr int SLICES = THREADS / GK;
        const int e = tid % GK;
        const int s = tid / GK;
        unsigned long long r = 0;
        if (s < SLICES) {
            for (int b = s; b < static_cast<int>(gridDim.x); b += SLICES) {
                r += __ldcg(scratch + static_cast<long long>(b) * GK + e);
            }
        }
        slab[tid] = r;
        __syncthreads();
        if (tid < GK) {
            unsigned long long v = 0;
#pragma unroll
            for (int u = 0; u < SLICES; ++u) v += slab[u * GK + tid];
            tile[tid] = v;
        }
        __syncthreads();
        if (tid == 0) *p.ticket = 0u;
    }
    write_out(p.out, tile, tid);
}

template <bool VEC>
cudaError_t launch(const Q1Params& p, int blocks, cudaStream_t stream) {
    auto* kernel = q1_partials_kernel<VEC>;
    // the slab passes the 48 KB default of dynamic shared memory, and two
    // blocks an SM need the largest shared-memory carveout
    static cudaError_t raised = [&] {
        cudaError_t rc =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SLAB_BYTES);
        if (rc == cudaSuccess) {
            rc = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared);
        }
        return rc;
    }();
    if (raised != cudaSuccess) return raised;
    kernel<<<blocks, THREADS, SLAB_BYTES, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// *p is copied into the launch; vec selects the paired-load instance (see
// q1_partials_kernel). Returns the launch's cudaError_t (0 = success).
int q1_sums_launch(const Q1Params* p, int vec, int blocks, void* stream) {
    if (blocks < 1 || p->n < 0 || p->out == nullptr || p->count == nullptr ||
        p->cutoff == nullptr || (blocks > 1 && (p->scratch == nullptr || p->ticket == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(vec ? launch<true>(*p, blocks, s) : launch<false>(*p, blocks, s));
}

// sizeof(Q1Params) and the offsets of its fields, in declaration order,
// into out[0..13]; returns the number written.
int q1_params_layout(long long* out) {
    const long long v[] = {
        sizeof(Q1Params),
        offsetof(Q1Params, qty), offsetof(Q1Params, price), offsetof(Q1Params, disc),
        offsetof(Q1Params, tax), offsetof(Q1Params, rf), offsetof(Q1Params, ls),
        offsetof(Q1Params, ship), offsetof(Q1Params, count), offsetof(Q1Params, cutoff),
        offsetof(Q1Params, out), offsetof(Q1Params, scratch), offsetof(Q1Params, ticket),
        offsetof(Q1Params, n),
    };
    for (int i = 0; i < 14; ++i) out[i] = v[i];
    return 14;
}

}  // extern "C"
