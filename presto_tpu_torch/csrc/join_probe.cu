// Hash-join probe: the first verified match of every probe row in a table
// of packed 8-byte slots, in one launch.
//
// Replaces presto_tpu/ops/pallas_join.py::_pallas_probe_kernel (the Pallas
// TPU kernel launched by _pallas_probe_first) together with the host key
// check that drives it (_probe_n1 with _host_verify). For every probe row i
// with live[i] and every probe key non-NULL, with
//
//   tag     = min(hash[i] >> 32, 0xFFFFFFFE)      (unsigned, as _tag_desired)
//   desired = tag >> (32 - bits)
//
// it scans the slots desired, desired + 1, ... up to the first vacant one
// (EMPTY tag 0xFFFFFFFF; the table's last slot is always vacant, so every
// scan ends without wrap-around) and stops at the first slot whose tag is
// `tag` AND whose build row r has every key equal to row i's:
//
//   probe_k[i] == build_k[r] in every lane, and build_k[r] non-NULL.
//
// It writes matched[i] (0/1) and brow[i] = r, or -1 when there is none.
// Equality is C++ `==` on the stored values, as torch's `==` in the plain
// version: float NaN never equals anything and -0.0 equals 0.0; varchar
// keys arrive as codes of one dictionary (the caller unifies them); long
// decimals compare both int64 lanes.
//
// The TPU kernel stops at the first TAG match within 16 slots, and the host
// verifies keys and relaunches, which on this card would cost a host read
// and a dozen gathers and scatters every round. Here the thread that finds
// a tag match reads the build row's keys itself and goes on past a
// collision, so one launch does the whole slot-region probe. One 8-byte
// load per slot brings tag and row together; build keys are read only on a
// tag match.
//
// Keys travel by value in ProbeParams (__grid_constant__): per key the
// probe and build data, their validity masks (null = no NULLs), an element
// kind and a lane count. The capacity is MAX_KEYS = 8 keys; no TPC-H join
// has more than two. The wrapper raises NotPortedError beyond it.
//
// Bound: random device-memory accesses. Each probe row reads its 8-byte
// hash and 1-byte live flag (and 1 byte per nullable probe key) and writes
// 5 bytes; a scan touches about one random slot at load <= 1/2, one 32-byte
// sector (at most the table's bytes over all rows); a matched row reads its
// probe keys and one random sector of each build key (at most the build
// column's bytes).
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (ops/join_kernel.py, cuda_build.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

constexpr int MAX_KEYS = 8;

// element kinds of a key column (ops/join_kernel.py KEY_KINDS)
enum KeyKind { KIND_B8 = 0, KIND_I16 = 1, KIND_I32 = 2, KIND_I64 = 3, KIND_F32 = 4, KIND_F64 = 5 };

struct ProbeKey {
    const void* probe;             // m rows x lanes
    const void* build;             // build rows x lanes
    const uint8_t* probe_valid;    // bool[m], or null: no NULLs
    const uint8_t* build_valid;    // bool[build rows], or null
    int kind;
    int lanes;
};

struct ProbeParams {
    const unsigned long long* slots;  // (tag, row) words
    const long long* hash;            // int64[m] probe row hashes
    const uint8_t* live;              // bool[m]
    uint8_t* matched;                 // bool[m]
    int* brow;                        // int32[m]
    long long m;
    int size;
    int bits;
    int num_keys;
    ProbeKey key[MAX_KEYS];
};

namespace {

constexpr int THREADS = 256;
constexpr uint32_t MAX_TAG = 0xFFFFFFFEu;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

template <typename T>
__device__ __forceinline__ bool lanes_equal(const void* a, long long i, const void* b, int r,
                                            int lanes) {
    const T* x = static_cast<const T*>(a) + i * lanes;
    const T* y = static_cast<const T*>(b) + static_cast<long long>(r) * lanes;
    for (int l = 0; l < lanes; ++l) {
        if (!(x[l] == y[l])) return false;
    }
    return true;
}

__device__ bool keys_equal(const ProbeParams& p, long long i, int r) {
    for (int k = 0; k < p.num_keys; ++k) {
        const ProbeKey& key = p.key[k];
        if (key.build_valid != nullptr && !key.build_valid[r]) return false;
        bool eq;
        switch (key.kind) {
            case KIND_B8: eq = lanes_equal<uint8_t>(key.probe, i, key.build, r, key.lanes); break;
            case KIND_I16: eq = lanes_equal<int16_t>(key.probe, i, key.build, r, key.lanes); break;
            case KIND_I32: eq = lanes_equal<int32_t>(key.probe, i, key.build, r, key.lanes); break;
            case KIND_I64: eq = lanes_equal<long long>(key.probe, i, key.build, r, key.lanes); break;
            case KIND_F32: eq = lanes_equal<float>(key.probe, i, key.build, r, key.lanes); break;
            default: eq = lanes_equal<double>(key.probe, i, key.build, r, key.lanes); break;
        }
        if (!eq) return false;
    }
    return true;
}

__device__ __forceinline__ bool probe_keys_valid(const ProbeParams& p, long long i) {
    for (int k = 0; k < p.num_keys; ++k) {
        if (p.key[k].probe_valid != nullptr && !p.key[k].probe_valid[i]) return false;
    }
    return true;
}

__global__ void __launch_bounds__(THREADS)
join_probe_kernel(const __grid_constant__ ProbeParams p) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < p.m;
         i += stride) {
        int row = -1;
        if (p.live[i] && probe_keys_valid(p, i)) {
            const uint32_t high =
                static_cast<uint32_t>(static_cast<unsigned long long>(p.hash[i]) >> 32);
            const uint32_t tag = high < MAX_TAG ? high : MAX_TAG;
            for (int s = static_cast<int>(tag >> (32 - p.bits)); s < p.size; ++s) {
                const unsigned long long w = __ldg(p.slots + s);
                const uint32_t t = static_cast<uint32_t>(w);
                if (t == EMPTY) break;
                if (t == tag) {
                    const int r = static_cast<int>(w >> 32);
                    if (keys_equal(p, i, r)) {
                        row = r;
                        break;
                    }
                }
            }
        }
        p.matched[i] = row >= 0;
        p.brow[i] = row;
    }
}

}  // namespace

extern "C" {

// *p is copied into the launch. Returns the launch's cudaError_t
// (0 = success).
int join_probe_launch(const ProbeParams* p, int blocks, void* stream) {
    if (p->m < 1 || p->bits < 4 || p->bits > 30 || p->size < (1 << p->bits) + 1 ||
        p->num_keys < 0 || p->num_keys > MAX_KEYS || blocks < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    join_probe_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*p);
    return static_cast<int>(cudaGetLastError());
}

// sizeof(ProbeParams), its fields' offsets in declaration order, then
// sizeof(ProbeKey) and its fields' offsets, into out[0..17]; returns the
// number written.
int join_probe_params_layout(long long* out) {
    const long long v[] = {
        sizeof(ProbeParams),
        offsetof(ProbeParams, slots), offsetof(ProbeParams, hash), offsetof(ProbeParams, live),
        offsetof(ProbeParams, matched), offsetof(ProbeParams, brow), offsetof(ProbeParams, m),
        offsetof(ProbeParams, size), offsetof(ProbeParams, bits),
        offsetof(ProbeParams, num_keys), offsetof(ProbeParams, key),
        sizeof(ProbeKey),
        offsetof(ProbeKey, probe), offsetof(ProbeKey, build), offsetof(ProbeKey, probe_valid),
        offsetof(ProbeKey, build_valid), offsetof(ProbeKey, kind), offsetof(ProbeKey, lanes),
    };
    for (int i = 0; i < 18; ++i) out[i] = v[i];
    return 18;
}

}  // extern "C"
