// Hash-join build: bulk linear-probe insert into a table of packed 8-byte
// slots, in one launch.
//
// Replaces presto_tpu/ops/pallas_join.py::_pallas_insert_kernel (the Pallas
// TPU kernel launched by _pallas_build). What it computes is kernel 2's
// function, not its round structure. Each slot is one 8-byte word,
// (tag, row) as two int32 (the tag in the low half); vacant is all ones,
// (EMPTY = 0xFFFFFFFF, -1). For every row i with live[i]:
//
//   tag     = min(hash[i] >> 32, 0xFFFFFFFE)      (unsigned, as _tag_desired)
//   desired = tag >> (32 - bits)
//
// and the row takes the first slot it can claim among
//
//   cand_k = min(desired + k, size - 2),   k = 0 .. R_MAX - 1,
//
// writing (tag, i) there. A row that claimed none of its R_MAX slots
// appends (tag, i) to `overflow` (the caller sorts those by tag into the
// overflow region). The last slot (size - 1) stays vacant and ends every
// probe scan without wrap-around.
//
// The TPU kernel runs R_MAX rounds of scatter-then-confirm over all rows
// because a TPU has no atomics, and keeps tags and rows in two arrays. Here
// one thread walks one row's candidate slots: a plain read skips occupied
// slots, and ONE 64-bit atomicCAS (vacant -> (tag, i)) claims a slot with
// its tag and row together. Slots are never freed, so when the kernel ends
// every slot from a row's desired slot up to the one it won is occupied:
// the only invariant the probe needs. Which row wins a contended slot
// differs from the TPU's round order (and from run to run); every placement
// that keeps the invariant gives the same join results, so callers compare
// join results and table invariants, never slot words.
//
// The table and the overflow counter are one allocation of size + 1 words:
// the word past the table holds the counter in its low half. One memset of
// all ones on the stream makes every slot vacant and sets the counter to
// 0xFFFFFFFF, so a claim's index is atomicAdd(counter, 1) + 1 (mod 2^32)
// and after the launch the counter holds the overflow count minus one.
// The caller reads that one word: no flag array, no compaction pass.
//
// Bound: random device-memory accesses. Each row reads its 8-byte hash and
// 1-byte live flag once; at load <= 1/2 an inserted row touches about one
// random slot, one 32-byte sector (at most the table's bytes over all
// rows); the memset writes the table once; overflow pairs are written once.
// The design keeps one pass over the rows with no rounds and no host
// synchronisation, derives tag and desired slot in registers (no eager
// passes before the launch), and claims with one atomic per slot word.
//
// Parameters travel by value in InsertParams (__grid_constant__); its
// layout is checked against its ctypes twin in ops/join_kernel.py.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (ops/join_kernel.py, cuda_build.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

struct InsertParams {
    const long long* hash;      // int64[n] row hashes
    const uint8_t* live;        // bool[n]: live rows with non-NULL keys
    unsigned long long* slots;  // size + 1 words: the table, then the counter
    int2* overflow;             // int32 (tag, row) pairs, room for n
    long long n;
    int size;                   // 2^bits + R_MAX + 1 slots
    int bits;
};

namespace {

constexpr int R_MAX = 64;
constexpr int THREADS = 256;
constexpr uint32_t MAX_TAG = 0xFFFFFFFEu;
constexpr unsigned long long VACANT = ~0ull;

__global__ void __launch_bounds__(THREADS)
join_insert_kernel(const __grid_constant__ InsertParams p) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const int limit = p.size - 2;
    unsigned int* counter = reinterpret_cast<unsigned int*>(p.slots + p.size);
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < p.n;
         i += stride) {
        if (!p.live[i]) continue;
        const uint32_t high = static_cast<uint32_t>(static_cast<unsigned long long>(p.hash[i]) >> 32);
        const uint32_t tag = high < MAX_TAG ? high : MAX_TAG;
        const int desired = static_cast<int>(tag >> (32 - p.bits));
        const unsigned long long mine =
            (static_cast<unsigned long long>(static_cast<uint32_t>(i)) << 32) | tag;
        bool won = false;
        for (int k = 0; k < R_MAX && !won; ++k) {
            const int cand = min(desired + k, limit);
            // a stale read can only show a taken slot as vacant; the CAS
            // then fails, as it must
            if (__ldcg(p.slots + cand) != VACANT) continue;
            won = atomicCAS(p.slots + cand, VACANT, mine) == VACANT;
        }
        if (!won) {
            const unsigned int at = atomicAdd(counter, 1u) + 1u;
            p.overflow[at] = make_int2(static_cast<int>(tag), static_cast<int>(i));
        }
    }
}

}  // namespace

extern "C" {

// Sets the table and the counter to all ones on the stream, then launches
// the insert (none when n is 0). *p is copied into the launch. Returns the
// first failing call's cudaError_t (0 = success).
int join_insert_launch(const InsertParams* p, int blocks, void* stream) {
    if (p->bits < 4 || p->bits > 30 || p->size != (1 << p->bits) + R_MAX + 1 || p->n < 0 ||
        (p->n > 0 && (blocks < 1 || p->n >= (1ll << 31)))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(p->slots, 0xFF, (static_cast<size_t>(p->size) + 1) * 8, s);
    if (err != cudaSuccess || p->n == 0) return static_cast<int>(err);
    join_insert_kernel<<<blocks, THREADS, 0, s>>>(*p);
    return static_cast<int>(cudaGetLastError());
}

// sizeof(InsertParams) and the offsets of its fields, in declaration
// order, into out[0..7]; returns the number written.
int join_insert_params_layout(long long* out) {
    const long long v[] = {
        sizeof(InsertParams),
        offsetof(InsertParams, hash), offsetof(InsertParams, live),
        offsetof(InsertParams, slots), offsetof(InsertParams, overflow),
        offsetof(InsertParams, n), offsetof(InsertParams, size), offsetof(InsertParams, bits),
    };
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 8;
}

}  // extern "C"
