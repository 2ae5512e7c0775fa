// Hash-join probe: bounded first-tag-match scan of a linear-probe slot table.
//
// Replaces presto_tpu/ops/pallas_join.py::_pallas_probe_kernel (the Pallas
// TPU kernel launched by _pallas_probe_first). For every probe row i it
// scans at most max_scan slots from
//     cand_k = min(desired[i] + start[i] + k, size - 1),   k = 0 .. max_scan - 1
// and writes, exactly as the TPU kernel does,
//     pos[i]  = the first cand_k whose slot tag equals tag[i], else -1
//     row[i]  = slot_row[pos[i]], else -1
//     more[i] = 1 when the scan neither matched nor reached an EMPTY slot
//               (0xFFFFFFFF) within max_scan slots, else 0.
// Tags are compared as unsigned 32-bit patterns (probe tags are clamped
// below EMPTY by the caller). The caller verifies true key equality and
// relaunches on the rows that need more (start += max_scan) or whose tag
// match failed verification (start = pos - desired + 1). Given one table
// it is deterministic, so it equals its plain version bit for bit.
//
// The TPU kernel keeps the whole slot table in VMEM and blocks the probe
// rows over a grid. Here the slot table stays in device memory (it is at
// most 2^23 + 65 slots, 67 MB for both arrays, and the hot part stays in
// the 50 MB L2), and one thread scans one probe row, stopping at its first
// match or EMPTY slot.
//
// Bound: random device-memory accesses. Each row reads its three 4-byte
// inputs and writes three 4-byte outputs once, and at load <= 1/2 reads
// about one random slot tag (plus its slot row on a match), a 32-byte
// sector apiece.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (ops/join_kernel.py, cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t EMPTY = 0xFFFFFFFFu;

__global__ void join_probe_kernel(const uint32_t* __restrict__ slot_tag,
                                  const int32_t* __restrict__ slot_row, int size,
                                  const uint32_t* __restrict__ tag,
                                  const int32_t* __restrict__ desired,
                                  const int32_t* __restrict__ start, long long m,
                                  int max_scan, int32_t* __restrict__ pos,
                                  int32_t* __restrict__ row, int32_t* __restrict__ more) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long limit = size - 1;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
         i += stride) {
        const uint32_t t = tag[i];
        const long long base = static_cast<long long>(desired[i]) + start[i];
        int32_t p = -1, r = -1, need_more = 1;
        for (int k = 0; k < max_scan; ++k) {
            long long cand = base + k;
            if (cand > limit) cand = limit;
            const uint32_t s = slot_tag[cand];
            if (s == t) {
                p = static_cast<int32_t>(cand);
                r = slot_row[cand];
                need_more = 0;
                break;
            }
            if (s == EMPTY) {
                need_more = 0;
                break;
            }
        }
        pos[i] = p;
        row[i] = r;
        more[i] = need_more;
    }
}

}  // namespace

extern "C" {

// slot_tag/slot_row int32[size] (device); tag/desired/start int32[m];
// pos/row/more int32[m]. Returns the launch's cudaError_t (0 = success).
int join_probe(const void* slot_tag, const void* slot_row, int size, const void* tag,
               const void* desired, const void* start, long long m, int max_scan,
               void* pos, void* row, void* more, int blocks, int threads, void* stream) {
    if (size < 2 || m < 1 || max_scan < 1 || blocks < 1 || threads < 32 || threads > 1024) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    join_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(slot_tag), static_cast<const int32_t*>(slot_row), size,
        static_cast<const uint32_t*>(tag), static_cast<const int32_t*>(desired),
        static_cast<const int32_t*>(start), m, max_scan, static_cast<int32_t*>(pos),
        static_cast<int32_t*>(row), static_cast<int32_t*>(more));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
