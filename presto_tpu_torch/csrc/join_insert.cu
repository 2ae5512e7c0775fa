// Hash-join build: bulk linear-probe insert into a power-of-two slot table.
//
// Replaces presto_tpu/ops/pallas_join.py::_pallas_insert_kernel (the Pallas
// TPU kernel launched by _pallas_build). What it computes is kernel 2's
// function, not its round structure:
//
//   slot_tag[size] = EMPTY (0xFFFFFFFF), slot_row[size] = -1, then every row
//   i with row[i] >= 0 takes the first slot it can claim among
//       cand_k = min(desired[i] + k, size - 2),   k = 0 .. R_MAX - 1
//   (slot_row[cand] = row[i], slot_tag[cand] = tag[i]); a row that claimed
//   none of its R_MAX slots gets pending[i] = 1 (the caller tag-sorts those
//   into the overflow region). Rows with row[i] < 0 get pending[i] = 0.
//
// The TPU kernel runs R_MAX rounds of scatter-then-confirm over all rows
// because a TPU has no atomics. Here one thread walks one row's candidate
// slots and claims a slot with atomicCAS(slot_row, -1 -> row). Slots are
// never freed, so when the kernel ends every slot from a row's desired slot
// up to the one it won is occupied: the only invariant the probe needs.
// Which row wins a contended slot differs from the TPU's round order (and
// from run to run); every placement that keeps the invariant gives the same
// join results, so callers compare join results and table invariants,
// never slot arrays. The last slot (size - 1) stays EMPTY and ends every
// probe scan without wrap-around.
//
// Bound: random device-memory accesses. Each row reads its three 4-byte
// inputs and writes its pending flag once, and at load <= 1/2 touches about
// one random slot of each array (a 32-byte sector apiece); the memset writes
// both slot arrays once. The design keeps one pass over the rows with no
// rounds and no host synchronisation; a plain read before the CAS keeps
// occupied slots from costing an atomic.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (ops/join_kernel.py, cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R_MAX = 64;

__global__ void join_insert_kernel(const int32_t* __restrict__ tag,
                                   const int32_t* __restrict__ row,
                                   const int32_t* __restrict__ desired, long long n,
                                   int size, int32_t* __restrict__ slot_tag,
                                   int32_t* slot_row, int32_t* __restrict__ pending) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const int limit = size - 2;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const int32_t r = row[i];
        if (r < 0) {
            pending[i] = 0;
            continue;
        }
        const int d = desired[i];
        int won = 0;
        for (int k = 0; k < R_MAX; ++k) {
            int cand = d + k;
            if (cand > limit) cand = limit;
            // a stale read can only show a slot as vacant that is taken;
            // the CAS then fails, as it must
            if (slot_row[cand] != -1) continue;
            if (atomicCAS(slot_row + cand, -1, r) == -1) {
                slot_tag[cand] = tag[i];
                won = 1;
                break;
            }
        }
        pending[i] = won ? 0 : 1;
    }
}

}  // namespace

extern "C" {

// tag/row/desired int32[n] (device), slot_tag/slot_row int32[size],
// pending int32[n]. Sets both slot arrays to all ones (EMPTY / -1) on the
// stream, then launches the insert. Returns the launch's cudaError_t.
int join_insert(const void* tag, const void* row, const void* desired, long long n,
                int size, void* slot_tag, void* slot_row, void* pending, int blocks,
                int threads, void* stream) {
    if (size < R_MAX + 2 || n < 0 || threads < 32 || threads > 1024) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(slot_tag, 0xFF, static_cast<size_t>(size) * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemsetAsync(slot_row, 0xFF, static_cast<size_t>(size) * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return 0;
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    join_insert_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(tag), static_cast<const int32_t*>(row),
        static_cast<const int32_t*>(desired), n, size, static_cast<int32_t*>(slot_tag),
        static_cast<int32_t*>(slot_row), static_cast<int32_t*>(pending));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
