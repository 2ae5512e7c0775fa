// Fused TPC-H Q1 aggregation: one pass over lineitem, per-block partial
// sums of every Q1 aggregate for the 6 (returnflag, linestatus) groups.
//
// Replaces presto_tpu/ops/pallas_agg.py::_kernel (the Pallas TPU kernel
// launched by q1_partial_sums). What it computes, over rows with
//     row < min(n, *count)  &&  ship[row] <= *cutoff
//     &&  0 <= g < 6,  g = rf[row] * 2 + ls[row]
// is, per group g, eight int64 channels:
//     0 count   1 qty   2 price   3 disc
//     4, 5  disc_price = price * (100 - disc)            as hi and lo lanes
//     6, 7  charge     = disc_price * (100 + tax)        as hi and lo lanes
// where a lane pair is v >> 32 (arithmetic) and v & 0xFFFFFFFF, the radix
// 2^32 layout of ops/decimal128.py. Each block writes one (6, 8) tile; the
// caller sums the tiles over blocks and normalizes the lanes
// (ops/agg_kernel.py), as the JAX package folds its tiles outside its kernel.
//
// Exactness: per row, disc_price and charge fit in int64 for any int32 price
// and DECIMAL(4,2) disc and tax (|charge| < 2^31 * 2^14.1 * 2^14.1 < 2^63),
// but a group's sum of charge passes 2^63 near SF 100, so they are never
// summed as one int64: the hi lanes stay below 2^27 a row and the lo lanes
// below 2^32, so their int64 sums are exact for any row count below 2^31.
//
// The TPU kernel's workarounds are gone: Hopper has int64 arithmetic, so
// there are no 16-bit limb channels, no int32 casts, no (128, 128) tile
// view and no padding of the columns to a multiple of the block size. The
// kernel reads the columns in their storage types (int64 decimals, int32
// codes and date), n rows, with no copies.
//
// Bound: device-memory bytes, 44 a row (four int64 and three int32
// columns) against a few dozen integer operations a row. Design: a
// grid-stride loop, coalesced loads, the 6 x 8 accumulators in registers
// (added under a predicate per group, so they are never indexed
// dynamically), then a warp-shuffle reduction of each accumulator and one
// shared-memory atomic per warp and accumulator.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (ops/agg_kernel.py, cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 6;
constexpr int K = 8;
constexpr long long MASK32 = 0xFFFFFFFFLL;

__global__ void __launch_bounds__(256) q1_partials_kernel(
    const long long* __restrict__ qty, const long long* __restrict__ price,
    const long long* __restrict__ disc, const long long* __restrict__ tax,
    const int32_t* __restrict__ rf, const int32_t* __restrict__ ls,
    const int32_t* __restrict__ ship, const int32_t* __restrict__ count,
    const int32_t* __restrict__ cutoff, long long n, long long* __restrict__ out) {
    __shared__ unsigned long long sums[G * K];
    for (int i = threadIdx.x; i < G * K; i += blockDim.x) sums[i] = 0;
    __syncthreads();

    long long acc[G][K];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int k = 0; k < K; ++k) acc[g][k] = 0;
    }

    long long limit = static_cast<long long>(*count);
    if (limit > n) limit = n;
    const int cut = *cutoff;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         row < limit; row += stride) {
        const int g = rf[row] * 2 + ls[row];
        if (ship[row] > cut || g < 0 || g >= G) continue;
        const long long p = price[row];
        const long long d = disc[row];
        const long long dp = p * (100 - d);
        const long long ch = dp * (100 + tax[row]);
        const long long v[K] = {1, qty[row], p, d, dp >> 32, dp & MASK32, ch >> 32, ch & MASK32};
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
            if (g == gg) {
#pragma unroll
                for (int k = 0; k < K; ++k) acc[gg][k] += v[k];
            }
        }
    }

    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            long long x = acc[g][k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
            if (lane == 0) atomicAdd(&sums[g * K + k], static_cast<unsigned long long>(x));
        }
    }
    __syncthreads();

    long long* tile = out + static_cast<long long>(blockIdx.x) * (G * K);
    for (int i = threadIdx.x; i < G * K; i += blockDim.x) {
        tile[i] = static_cast<long long>(sums[i]);
    }
}

}  // namespace

extern "C" {

// qty, price, disc, tax int64[n]; rf, ls, ship int32[n]; count, cutoff
// int32[1] (device); out int64 (blocks, 6, 8). threads is a multiple of 32,
// at most 256. Returns the launch's cudaError_t (0 = success).
int q1_partials(const void* qty, const void* price, const void* disc, const void* tax,
                const void* rf, const void* ls, const void* ship, const void* count,
                const void* cutoff, long long n, void* out, int blocks, int threads,
                void* stream) {
    if (blocks < 1 || threads < 32 || threads > 256 || threads % 32 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    q1_partials_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(qty), static_cast<const long long*>(price),
        static_cast<const long long*>(disc), static_cast<const long long*>(tax),
        static_cast<const int32_t*>(rf), static_cast<const int32_t*>(ls),
        static_cast<const int32_t*>(ship), static_cast<const int32_t*>(count),
        static_cast<const int32_t*>(cutoff), n, static_cast<long long*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
