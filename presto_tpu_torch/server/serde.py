"""Page wire serde: pages <-> bytes for cross-process transport (torch
counterpart of presto_tpu/server/serde.py, with its wire format byte for
byte, so either package reads the other's frames).

Re-designed equivalent of the reference's SerializedPage + PagesSerde
(presto-main/.../execution/buffer/PagesSerde.java:39: block-encoded binary
pages with optional LZ4). A frame is a small JSON header (schema, types,
dictionary payloads) and the column buffers, compressed with the port's
own LZ4 block codec (presto_tpu_torch/native/), zlib or zstd.

* PTP1 frames: the raw body under one codec byte.
* PTP2 frames: light-weight encodings chosen per buffer from cheap
  vectorized statistics (constant, run-length, dictionary, zigzag delta,
  offset and width packing, bit-packed nulls), then the body cut into
  stripes compressed concurrently on a shared thread pool.

A page on the card leaves it in two device-to-host copies: its live row
count, then every buffer of its blocks packed into one device buffer. A
received page reaches the receiver's `device` in one host-to-device copy
of one packed buffer whose views become the blocks (count included).
`WireStats` counts both, the copies a page of the exchange costs.

In the JAX package, pages on the pull-based exchange are self-contained:
dictionaries ship with every page, which at TPC-H SF 1 puts 150,000
customer names, phones and addresses (3 MB each) into every page of a
Q10 exchange. Here every consumer reads a producer buffer in token order
through a `DictionaryCache` of its own (server/exchange.py), so when the
fleet negotiates `dict_cache` the producer keeps one cache per output
buffer and ships each dictionary once per buffer. Without it (a peer that
does not advertise it) pages stay self-contained.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from .. import native
from .. import types as T
from ..page import Block, LazyDict, Page, dictionary_by_id, intern_dictionary

_MAGIC = b"PTP1"
_MAGIC2 = b"PTP2"
WIRE_VERSION = 2

# absolute cap on one deserialized page (untrusted input bound: a corrupt
# or malicious header or stream cannot demand unbounded memory)
MAX_PAGE_BYTES = 1 << 30
# stripe-count bound: a corrupt v2 frame cannot demand an absurd header
MAX_STRIPES = 1 << 16

# a v2 body is compressed in stripes of this many bytes
_STRIPE_BYTES = 1 << 20
# skip the general codec when the encodings already shrank the body below
# this fraction of the logical bytes (packed buffers barely compress)
_SKIP_CODEC_RATIO = 0.55
# device buffers of a packed page start at this alignment (the kernels'
# vector loads want 16 bytes; 256 is cudaMalloc's own)
_ALIGN = 256

# zstd (codec 3) only where the zstandard wheel imports; its
# (de)compressors are not thread-safe, so each thread keeps its own
try:
    import zstandard as _zstd
except ImportError:
    _zstd = None
_zstd_tls = threading.local()


def _zstd_compress(raw: bytes) -> bytes:
    c = getattr(_zstd_tls, "c", None)
    if c is None:
        c = _zstd_tls.c = _zstd.ZstdCompressor(level=1)
    return c.compress(raw)


def _zstd_decompress(data: bytes, max_output_size: int) -> bytes:
    if _zstd is None:
        raise ValueError("zstd page received but zstandard is not installed")
    d = getattr(_zstd_tls, "d", None)
    if d is None:
        d = _zstd_tls.d = _zstd.ZstdDecompressor()
    return d.decompress(data, max_output_size=max_output_size)


# ---------------------------------------------------------------------------
# capability negotiation
# ---------------------------------------------------------------------------

# the codec set assumed of a peer that advertises nothing (an old build)
_BASELINE_CODECS = ("lz4", "zlib", "raw")
_CODEC_PREFERENCE = ("zstd", "lz4", "zlib", "raw")


def local_capabilities() -> dict:
    """Codecs and wire version this process decodes, advertised through the
    worker's /v1/status. lz4 is always advertised: the port ships its
    codec's source, and a build that fails raises at the first LZ4 call.
    The `hier` advert says this build reads the hierarchical exchange's
    ragged pages (server/hier.py); `dict_cache` that its exchange client
    reads each producer buffer with a DictionaryCache, so a producer may
    ship a dictionary once per buffer instead of once per page."""
    codecs = (["zstd"] if _zstd is not None else []) + list(_BASELINE_CODECS)
    return {
        "version": WIRE_VERSION,
        "codecs": codecs,
        "hier": {"ragged": True},
        "dict_cache": True,
    }


def baseline_capabilities() -> dict:
    """The wire format every build decodes: v1 frames and the baseline
    codecs. Right for a consumer that did not negotiate (a task spec
    without a "wire" field)."""
    return {"version": 1, "codecs": list(_BASELINE_CODECS)}


def negotiate(peer_caps: Sequence[Optional[dict]]) -> dict:
    """Intersect this process's capabilities with every peer's. A peer that
    advertises nothing (None: an old build, or a failed status probe)
    degrades the fleet to wire v1 and the baseline codecs."""
    caps = local_capabilities()
    version = caps["version"]
    codecs = set(caps["codecs"])
    hier = bool((caps.get("hier") or {}).get("ragged"))
    dict_cache = bool(caps.get("dict_cache"))
    for pc in peer_caps:
        if not isinstance(pc, dict):
            version = 1
            codecs &= set(_BASELINE_CODECS)
            hier = dict_cache = False
            continue
        dict_cache = dict_cache and bool(pc.get("dict_cache"))
        version = min(version, int(pc.get("version", 1)))
        codecs &= set(pc.get("codecs", _BASELINE_CODECS))
        # all or nothing: one worker without the advert degrades every
        # producer to the flat loop
        hier = hier and bool((pc.get("hier") or {}).get("ragged"))
    codecs.add("raw")  # the universal floor
    out = {
        "version": max(version, 1),
        "codecs": [c for c in _CODEC_PREFERENCE if c in codecs],
    }
    if hier:
        out["hier"] = {"ragged": True}
    if dict_cache:
        out["dict_cache"] = True
    return out


# ---------------------------------------------------------------------------
# wire stats
# ---------------------------------------------------------------------------


class WireStats:
    """Thread-safe encode/decode accounting of one exchange endpoint.
    `raw_bytes` is the logical (pre-encoding) size, so raw/wire is the
    compression ratio; `d2h_copies` and `h2d_copies` count the transfers
    between the card and the host that pages took."""

    def __init__(self):
        self._lock = threading.Lock()
        self.pages = 0
        self.raw_bytes = 0
        self.wire_bytes = 0  # encode side: bytes put on the wire
        self.decoded_pages = 0
        self.decoded_bytes = 0  # decode side, kept apart so a process that
        # does both never double-counts
        self.encode_s = 0.0
        self.decode_s = 0.0
        self.d2h_copies = 0
        self.h2d_copies = 0
        self.encodings: Dict[str, int] = {}

    def record_encode(self, raw: int, wire: int, seconds: float,
                      encodings: Optional[Sequence[str]] = None, copies: int = 0) -> None:
        with self._lock:
            self.pages += 1
            self.raw_bytes += raw
            self.wire_bytes += wire
            self.encode_s += seconds
            self.d2h_copies += copies
            for e in encodings or ():
                self.encodings[e] = self.encodings.get(e, 0) + 1

    def record_decode(self, wire: int, seconds: float, copies: int = 0) -> None:
        with self._lock:
            self.decoded_pages += 1
            self.decoded_bytes += wire
            self.decode_s += seconds
            self.h2d_copies += copies

    def merge_snapshot(self, snap: dict) -> None:
        """Fold a peer's snapshot() (a worker's status) into this one."""
        with self._lock:
            self.pages += snap.get("pages") or 0
            self.raw_bytes += snap.get("raw_bytes") or 0
            self.wire_bytes += snap.get("wire_bytes") or 0
            self.decoded_pages += snap.get("decoded_pages") or 0
            self.decoded_bytes += snap.get("decoded_bytes") or 0
            self.encode_s += (snap.get("encode_ms") or 0) / 1e3
            self.decode_s += (snap.get("decode_ms") or 0) / 1e3
            self.d2h_copies += snap.get("d2h_copies") or 0
            self.h2d_copies += snap.get("h2d_copies") or 0
            for k, v in (snap.get("encodings") or {}).items():
                self.encodings[k] = self.encodings.get(k, 0) + v

    def snapshot(self) -> dict:
        with self._lock:
            ratio = (round(self.raw_bytes / self.wire_bytes, 2)
                     if self.wire_bytes and self.raw_bytes else None)
            return {
                "pages": self.pages,
                "raw_bytes": self.raw_bytes,
                "wire_bytes": self.wire_bytes,
                "decoded_pages": self.decoded_pages,
                "decoded_bytes": self.decoded_bytes,
                "encode_ms": round(self.encode_s * 1e3, 2),
                "decode_ms": round(self.decode_s * 1e3, 2),
                "compression_ratio": ratio,
                "d2h_copies": self.d2h_copies,
                "h2d_copies": self.h2d_copies,
                "encodings": dict(self.encodings),
            }


# ---------------------------------------------------------------------------
# striped parallel compression
# ---------------------------------------------------------------------------

_pool_lock = threading.Lock()
_pool = None
_pool_unavailable = False


def _stripe_pool():
    """Shared pool for stripe (de)compression and per-buffer encodings (the
    LZ4 ctypes calls, zlib, zstd and numpy release the GIL). None on a
    single-core host, where the work runs inline."""
    global _pool, _pool_unavailable
    if _pool is not None or _pool_unavailable:
        return _pool
    with _pool_lock:
        if _pool is None and not _pool_unavailable:
            workers = min(os.cpu_count() or 1, 8)
            if workers < 2:
                _pool_unavailable = True
                return None
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="ptpu-stripe")
    return _pool


def shutdown_stripe_pool() -> None:
    """Stop the shared pool's threads (a later frame starts it anew)."""
    global _pool
    with _pool_lock:
        pool, _pool = _pool, None
    if pool is not None:
        pool.shutdown(wait=True)


_CODEC_IDS = {"raw": 0, "zlib": 1, "lz4": 2, "zstd": 3}


def _pick_codec(caps: Optional[dict]) -> str:
    """The first codec of the preference order that every negotiated peer
    decodes. lz4 is picked whether or not this process built its codec:
    a failed build raises at the compress call."""
    allowed = (caps or local_capabilities()).get("codecs") or _BASELINE_CODECS
    for c in _CODEC_PREFERENCE:
        if c not in allowed or (c == "zstd" and _zstd is None):
            continue
        return c
    return "raw"


def _compress_one(codec: str, data: bytes) -> bytes:
    if codec == "zstd":
        return _zstd_compress(data)
    if codec == "lz4":
        return native.lz4_compress(data)
    if codec == "zlib":
        return zlib.compress(data, 1)
    return data


def _decompress_one(codec: str, blob: bytes, orig: int) -> bytes:
    if codec == "zstd":
        return _zstd_decompress(blob, orig)
    if codec == "lz4":
        return native.lz4_decompress(blob, orig)
    if codec == "zlib":
        d = zlib.decompressobj()
        out = d.decompress(blob, orig)
        if d.unconsumed_tail or len(out) != orig:
            raise ValueError("zlib stripe inflated to an unexpected size")
        return out
    return blob


def _frame_v2(raw: bytes, codec: str) -> bytes:
    """PTP2 | codec u8 | nstripes u32 | (orig u32, comp u32)* | blobs.
    Stripes compress concurrently; a frame whose compressed total is not
    smaller than its input degrades to one raw stripe."""
    n = len(raw)
    if codec != "raw" and n > 0:
        view = memoryview(raw)
        stripes = [bytes(view[i:i + _STRIPE_BYTES]) for i in range(0, n, _STRIPE_BYTES)]
        pool = _stripe_pool()
        if pool is not None and len(stripes) > 1:
            blobs = list(pool.map(lambda s: _compress_one(codec, s), stripes))
        else:
            blobs = [_compress_one(codec, s) for s in stripes]
        if sum(len(b) for b in blobs) < n:
            out = io.BytesIO()
            out.write(_MAGIC2)
            out.write(bytes([_CODEC_IDS[codec]]))
            out.write(len(stripes).to_bytes(4, "little"))
            for s, b in zip(stripes, blobs):
                out.write(len(s).to_bytes(4, "little"))
                out.write(len(b).to_bytes(4, "little"))
            for b in blobs:
                out.write(b)
            return out.getvalue()
    return (_MAGIC2 + b"\x00" + (1).to_bytes(4, "little") + n.to_bytes(4, "little")
            + n.to_bytes(4, "little") + raw)


def _deframe_v2(data: bytes) -> bytes:
    """Parse and validate a PTP2 stripe frame, decompressing stripes
    concurrently. Every field is untrusted: stripe counts and sizes are
    bounded before any allocation."""
    if len(data) < 9:
        raise ValueError("truncated PTP2 frame")
    codec_id = data[4]
    codec = {v: k for k, v in _CODEC_IDS.items()}.get(codec_id)
    if codec is None:
        raise ValueError(f"unknown page codec {codec_id}")
    nstripes = int.from_bytes(data[5:9], "little")
    if not 1 <= nstripes <= MAX_STRIPES:
        raise ValueError(f"implausible stripe count {nstripes}")
    head_end = 9 + 8 * nstripes
    if len(data) < head_end:
        raise ValueError("truncated stripe header")
    origs: List[int] = []
    comps: List[int] = []
    total_orig = 0
    for i in range(nstripes):
        o = int.from_bytes(data[9 + 8 * i:13 + 8 * i], "little")
        c = int.from_bytes(data[13 + 8 * i:17 + 8 * i], "little")
        total_orig += o
        if total_orig > MAX_PAGE_BYTES:
            raise ValueError(f"stripe header declares more than the {MAX_PAGE_BYTES}-byte "
                             "page cap")
        # block codecs expand far less than 256x: a corrupt header cannot
        # demand an implausible inflation
        if codec != "raw" and o > max(256 * max(c, 1), 1 << 12):
            raise ValueError(f"stripe {i} declares implausible size {o} for {c} "
                             "compressed bytes")
        origs.append(o)
        comps.append(c)
    if len(data) - head_end != sum(comps):
        raise ValueError("stripe payload length mismatch")
    view = memoryview(data)
    blobs = []
    off = head_end
    for c in comps:
        blobs.append(bytes(view[off:off + c]))
        off += c
    pool = _stripe_pool()
    if codec == "raw":
        parts = blobs
    elif pool is not None and nstripes > 1:
        parts = list(pool.map(lambda t: _decompress_one(codec, t[0], t[1]), zip(blobs, origs)))
    else:
        parts = [_decompress_one(codec, b, o) for b, o in zip(blobs, origs)]
    for p, o in zip(parts, origs):
        if len(p) != o:
            raise ValueError("stripe inflated to an unexpected size")
    return b"".join(parts)


# ---------------------------------------------------------------------------
# light-weight columnar encodings (numpy, the JAX package's own code)
# ---------------------------------------------------------------------------

def _width_dtype(maxval: int) -> np.dtype:
    if maxval < (1 << 8):
        return np.dtype("<u1")
    if maxval < (1 << 16):
        return np.dtype("<u2")
    if maxval < (1 << 32):
        return np.dtype("<u4")
    return np.dtype("<u8")


def _to_u64(flat: np.ndarray) -> np.ndarray:
    """View/convert any integer array into the modular uint64 domain
    (sign-extended), where offset/delta arithmetic is exact for every
    input — including full-range int64."""
    if flat.dtype == np.uint64:
        return flat
    if flat.dtype == np.int64:
        return flat.view(np.uint64)
    return flat.astype(np.int64).view(np.uint64)


def _from_u64(u: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Inverse of `_to_u64`: modular cast back to the original dtype
    (two's-complement truncation — exact because the encoded values fit)."""
    if dtype == np.uint64:
        return u
    if np.dtype(dtype).kind == "i":
        return u.astype(np.uint64).view(np.int64).astype(dtype)
    return u.astype(dtype)


_DICT_RANGE_MAX = 1 << 16  # bincount-based NDV probe stays O(n) + small


def _signed_width(lo: int, hi: int) -> int:
    """Smallest byte width whose SIGNED range holds [lo, hi]."""
    for w in (1, 2, 4):
        if -(1 << (8 * w - 1)) <= lo and hi < (1 << (8 * w - 1)):
            return w
    return 8


def _encode_array(arr: np.ndarray):
    """(encoding descriptor | None, payload ndarray-or-bytes). None means
    raw C-order bytes.

    Encodings are chosen by exact byte cost from one cheap vectorized
    stats pass (min/max, modular deltas, bincount NDV for small ranges) —
    the per-column analog of the reference's block encodings
    (RunLengthEncodedBlock, DictionaryBlock, int packing), applied on the
    wire where this engine's device pages are plain fixed-width arrays.
    All integer arithmetic runs modulo 2^64 on both ends, so truncation
    is exact for every input including full-range int64. The hot path is
    deliberately few-pass: one reduction pair for min/max, one diff, one
    truncating store — serialize wall time IS this function."""
    a = np.ascontiguousarray(arr)
    n = a.size
    if n < 64:
        return None, a
    if a.dtype == np.bool_:
        # bit-packed bitmap: 8x smaller before the codec ever runs
        return {"k": "bits"}, np.packbits(a.reshape(-1))
    kind = a.dtype.kind
    if kind == "f":
        # floats: constant detection only (bitwise, NaN-safe)
        bits = a.view(_width_dtype((1 << (8 * a.dtype.itemsize)) - 1)).reshape(-1)
        if bits.min() == bits.max():
            return {"k": "const"}, a.reshape(-1)[:1]
        return None, a
    if kind not in "iu":
        return None, a

    # integer lanes: multi-dim arrays (decimal limbs, collection widths)
    # encode lane-contiguous (Fortran flatten) so deltas run down a lane
    fortran = a.ndim > 1
    flat = np.ascontiguousarray(a.T).reshape(-1) if fortran else a.reshape(-1)
    mn_s, mx_s = int(flat.min()), int(flat.max())
    base = {"F": 1} if fortran else {}
    if mn_s == mx_s:
        return {"k": "const", **base}, flat[:1]
    u = _to_u64(flat)
    off_u = np.uint64(mn_s & 0xFFFFFFFFFFFFFFFF)
    rng = mx_s - mn_s  # exact python int — never overflows
    off_dt = _width_dtype(rng)
    itemsize = a.dtype.itemsize
    best_kind = None
    best_cost = n * itemsize  # raw
    if off_dt.itemsize < itemsize:
        best_kind, best_cost = "off", n * off_dt.itemsize

    # probe delta/RLE/NDV stats on contiguous sample chunks first: the
    # full-array diff/bincount temporaries are the expensive part of a
    # serialize (multi-MB allocations), so they only run when the sample
    # says the encoding can plausibly win. The probe only GATES — every
    # chosen encoding is verified on exact full-array stats below.
    if n > 65536:
        step = n // 8
        chunks = [u[i * step : i * step + 512] for i in range(8)]
        dsamp = np.concatenate([np.diff(c) for c in chunks])
        ssamp = np.concatenate(chunks)
    else:
        dsamp = np.diff(u)
        ssamp = u
    dss = dsamp.view(np.int64)
    dw_est = _signed_width(int(dss.min()), int(dss.max())) if dss.size else 1
    run_frac = (
        np.count_nonzero(dsamp) / dsamp.size if dsamp.size else 1.0
    )

    # modular delta, stored sign-truncated: sorted/clustered ints (keys,
    # dates, row ids) shrink to their STEP width
    d = dw = None
    nruns = None
    probe_delta = itemsize + n * dw_est < best_cost
    probe_rle = run_frac < 0.25
    if (probe_delta or probe_rle) and n > 1:
        d = np.diff(u)
        ds = d.view(np.int64)
        dw = _signed_width(int(ds.min()), int(ds.max()))
        delta_cost = itemsize + ds.size * dw
        if delta_cost < best_cost:
            best_kind, best_cost = "delta", delta_cost
        # run-length: few runs of repeated values (sorted keys, flags)
        nruns = int(np.count_nonzero(d)) + 1
        if nruns * 4 < n:
            run_dt = _width_dtype(n)
            rle_cost = nruns * (off_dt.itemsize + run_dt.itemsize)
            if rle_cost < best_cost:
                best_kind, best_cost = "rle", rle_cost

    # dictionary: low NDV over a bounded range (bincount keeps the NDV
    # probe O(n) — wide-range low-NDV columns fall through to delta/raw).
    # Gate on the sampled NDV so high-NDV columns skip the code build.
    counts = vals = None
    if (
        rng <= _DICT_RANGE_MAX
        and off_dt.itemsize > 1
        and np.unique(ssamp).size <= 512
    ):
        vals = np.subtract(u, off_u, dtype=np.int64, casting="unsafe")
        counts = np.bincount(vals, minlength=rng + 1)
        nu = int(np.count_nonzero(counts))
        code_dt = _width_dtype(max(nu - 1, 0))
        dict_cost = nu * off_dt.itemsize + n * code_dt.itemsize
        if dict_cost < best_cost:
            best_kind, best_cost = "dict", dict_cost

    if best_kind is None:
        return None, a  # raw keeps C order (the no-descriptor contract)
    if best_kind == "off":
        # modular homomorphism: truncate-then-subtract == subtract-then-
        # truncate, so the whole encode is ONE casting ufunc pass
        vals = np.subtract(u, off_u, dtype=off_dt, casting="unsafe")
        return {"k": "off", "o": mn_s, "w": off_dt.itemsize, **base}, vals
    if best_kind == "delta":
        return (
            {"k": "delta", "f": int(flat[0]), "w": dw, **base},
            d.astype(_u_dt(dw)),  # modular truncate; exact by width check
        )
    if best_kind == "rle":
        run_dt = _width_dtype(n)
        starts = np.concatenate([np.zeros(1, np.int64), np.flatnonzero(d) + 1])
        lengths = np.diff(np.append(starts, n)).astype(run_dt)
        rvals = (u[starts] - off_u).astype(off_dt)
        return (
            {"k": "rle", "o": mn_s, "w": off_dt.itemsize,
             "rw": run_dt.itemsize, "nr": nruns, **base},
            rvals.tobytes() + lengths.tobytes(),
        )
    # dict
    code_map = np.cumsum(counts > 0) - 1
    nu = int(np.count_nonzero(counts))
    code_dt = _width_dtype(max(nu - 1, 0))
    codes = code_map[vals].astype(code_dt)
    uniq = np.flatnonzero(counts).astype(off_dt)
    return (
        {"k": "dict", "o": mn_s, "w": off_dt.itemsize,
         "cw": code_dt.itemsize, "nu": nu, **base},
        uniq.tobytes() + codes.tobytes(),
    )


def _u_dt(width: int) -> np.dtype:
    return {1: np.dtype("<u1"), 2: np.dtype("<u2"),
            4: np.dtype("<u4"), 8: np.dtype("<u8")}[int(width)]


def _decode_array(desc: Optional[dict], buf, dtype: np.dtype,
                  shape: Sequence[int],
                  budget: Optional[dict] = None) -> np.ndarray:
    """Inverse of `_encode_array`. `buf` and the header-declared shape
    are untrusted wire input: frombuffer raises on short payloads, and
    the MATERIALIZED size is bounded — const/rle/dict expand beyond the
    (stripe-bounded) wire bytes, so a corrupt header must not be able to
    demand a huge allocation. `budget` ({"left": bytes}) caps the whole
    page cumulatively across its columns."""
    dtype = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    nbytes = n * dtype.itemsize
    if n < 0 or nbytes > MAX_PAGE_BYTES:
        raise ValueError(
            f"column declares {n} elements ({nbytes} bytes), "
            f"past the {MAX_PAGE_BYTES}-byte page cap"
        )
    if budget is not None:
        budget["left"] -= nbytes
        if budget["left"] < 0:
            raise ValueError(
                f"page columns declare more than the {MAX_PAGE_BYTES}-byte "
                "page cap in total"
            )
    if desc is None:
        arr = np.frombuffer(buf, dtype=dtype, count=n)
        return arr.reshape(shape)
    k = desc.get("k")
    fortran = bool(desc.get("F"))

    def out_shape(flat):
        if fortran:
            return flat.reshape(tuple(reversed(shape))).T
        return flat.reshape(shape)

    if k == "bits":
        flat = np.unpackbits(
            np.frombuffer(buf, dtype=np.uint8), count=n
        ).astype(np.bool_)
        return flat.reshape(shape)
    if k == "const":
        v = np.frombuffer(buf, dtype=dtype, count=1)
        return out_shape(np.broadcast_to(v, (n,)).copy())
    if k == "off":
        vals = np.frombuffer(buf, dtype=_u_dt(desc["w"]), count=n)
        u = vals.astype(np.uint64) + np.uint64(int(desc["o"]) & 0xFFFFFFFFFFFFFFFF)
        return out_shape(_from_u64(u, dtype))
    if k == "delta":
        if n == 0:
            return out_shape(np.zeros(0, dtype))
        w = int(desc["w"])
        st = np.frombuffer(buf, dtype=_u_dt(w), count=max(n - 1, 0))
        sdt = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[w]
        # sign-extend the truncated modular deltas, then rebuild the
        # absolutes by modular cumsum from the first value
        ds = st.view(sdt).astype(np.int64).view(np.uint64)
        u = np.empty(n, np.uint64)
        u[0] = np.uint64(int(desc["f"]) & 0xFFFFFFFFFFFFFFFF)
        if n > 1:
            np.cumsum(ds, out=u[1:])
            u[1:] += u[0]
        return out_shape(_from_u64(u, dtype))
    if k == "rle":
        nr = int(desc["nr"])
        vw, rw = int(desc["w"]), int(desc["rw"])
        if nr < 0 or nr > n:
            raise ValueError(f"implausible run count {nr}")
        rvals = np.frombuffer(buf, dtype=_u_dt(vw), count=nr, offset=0)
        lengths = np.frombuffer(
            buf, dtype=_u_dt(rw), count=nr, offset=nr * vw
        ).astype(np.int64)
        if int(lengths.sum()) != n:
            raise ValueError("run lengths do not cover the buffer")
        u = np.repeat(
            rvals.astype(np.uint64)
            + np.uint64(int(desc["o"]) & 0xFFFFFFFFFFFFFFFF),
            lengths,
        )
        return out_shape(_from_u64(u, dtype))
    if k == "dict":
        nu = int(desc["nu"])
        vw, cw = int(desc["w"]), int(desc["cw"])
        if nu <= 0 or nu > n:
            raise ValueError(f"implausible dictionary size {nu}")
        uniq = np.frombuffer(buf, dtype=_u_dt(vw), count=nu, offset=0)
        codes = np.frombuffer(
            buf, dtype=_u_dt(cw), count=n, offset=nu * vw
        ).astype(np.int64)
        if codes.size and int(codes.max()) >= nu:
            raise ValueError("dictionary code out of range")
        u = uniq.astype(np.uint64)[codes] + np.uint64(
            int(desc["o"]) & 0xFFFFFFFFFFFFFFFF
        )
        return out_shape(_from_u64(u, dtype))
    raise ValueError(f"unknown buffer encoding {k!r}")


class UnsortedEntries(LazyDict):
    """A received dictionary whose entries do not run in string order (a
    TPC-H phone or address domain): interned as it is, it would pass for a
    sorted tuple, and comparisons on its codes would order wrongly. Marked
    unsorted, it makes them raise as they do on the sender."""

    is_sorted = False

    def __init__(self, entries):
        self.entries = tuple(entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, UnsortedEntries) and self.entries == other.entries

    def __hash__(self):
        return hash(("unsorted", self.entries))


class DictionaryCache:
    """Which interned dictionaries the peer already holds (sender side),
    or the local ids of remote ids (receiver side)."""

    def __init__(self):
        self.sent: Set[int] = set()
        self.remote_to_local: Dict[int, int] = {}


_ENTRIES_LOCK = threading.Lock()
_ENTRIES: Dict[int, list] = {}  # dict id -> its entries, newest last
_ENTRIES_KEEP = 16


def _dictionary_entries(dict_id: int) -> list:
    """The entries of an interned dictionary as a list, materialized once
    per process for the last few ids (a lazy dictionary of 150,000 TPC-H
    addresses takes seconds to list)."""
    with _ENTRIES_LOCK:
        got = _ENTRIES.pop(dict_id, None)
        if got is not None:
            _ENTRIES[dict_id] = got
            return got
    got = list(dictionary_by_id(dict_id))
    with _ENTRIES_LOCK:
        _ENTRIES[dict_id] = got
        while len(_ENTRIES) > _ENTRIES_KEEP:
            _ENTRIES.pop(next(iter(_ENTRIES)))
    return got


# ---------------------------------------------------------------------------
# pages <-> host buffers: the transfers between the card and the host
# ---------------------------------------------------------------------------

_TORCH_OF_NP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_NP_OF_TORCH = {v: k for k, v in _TORCH_OF_NP.items()}


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _fetch_host(tensors: Sequence[torch.Tensor]):
    """numpy arrays of `tensors` (all on one device) and the number of
    device-to-host copies it took: none on the CPU, else one, of every
    buffer packed into one device buffer."""
    if not tensors or tensors[0].device.type == "cpu":
        return [t.contiguous().numpy() for t in tensors], 0
    offs, total = [], 0
    for t in tensors:
        offs.append(total)
        total += _aligned(t.numel() * t.element_size())
    packed = torch.empty(max(total, 1), dtype=torch.uint8, device=tensors[0].device)
    for t, off in zip(tensors, offs):
        nb = t.numel() * t.element_size()
        if nb:
            packed[off:off + nb].copy_(t.contiguous().reshape(-1).view(torch.uint8))
    host = packed.cpu().numpy()
    out = []
    for t, off in zip(tensors, offs):
        nb = t.numel() * t.element_size()
        out.append(host[off:off + nb].view(_NP_OF_TORCH[t.dtype]).reshape(tuple(t.shape)))
    return out, 1


def _to_device(arrays: Sequence[np.ndarray], count: int, device):
    """(tensors of `arrays`, 0-d int32 count tensor) on `device`, from one
    packed host buffer moved in one host-to-device copy (none on the CPU),
    and the number of copies."""
    offs, total = [0], _ALIGN  # the count leads
    for a in arrays:
        offs.append(total)
        total += _aligned(a.nbytes)
    host = np.empty(total, np.uint8)
    host[:4].view(np.int32)[0] = count
    for a, off in zip(arrays, offs[1:]):
        if a.nbytes:
            host[off:off + a.nbytes].view(a.dtype).reshape(a.shape)[...] = a
    buf = torch.from_numpy(host)
    copies = 0
    if device.type != "cpu":
        buf = buf.to(device)
        copies = 1
    out = []
    for a, off in zip(arrays, offs[1:]):
        out.append(buf[off:off + a.nbytes].view(_TORCH_OF_NP[a.dtype]).reshape(a.shape))
    return out, buf[:4].view(torch.int32).reshape(()), copies


def _block_tensors(b: Block, n: int) -> List[torch.Tensor]:
    """The wire buffers of a block, in wire order: data, valid, lengths
    (int32), elem_valid, then the key block's."""
    out = [b.data[:n]]
    if b.valid is not None:
        out.append(b.valid[:n])
    if b.lengths is not None:
        out.append(b.lengths[:n].to(torch.int32))
    if b.elem_valid is not None:
        out.append(b.elem_valid[:n])
    if b.key_block is not None:
        out.extend(_block_tensors(b.key_block, n))
    return out


def page_to_host(page: Page, n: int):
    """(the first `n` rows of `page` as a CPU page, device-to-host copies):
    one packed copy for a page on the card, none for one on the CPU."""
    tensors: List[torch.Tensor] = []
    for b in page.blocks:
        tensors.extend(_block_tensors(b, n))
    arrays, copies = _fetch_host(tensors)
    it = iter(torch.from_numpy(a) for a in arrays)

    def rebuild(b: Block) -> Block:
        data = next(it)
        valid = None if b.valid is None else next(it)
        lengths = None if b.lengths is None else next(it)
        ev = None if b.elem_valid is None else next(it)
        key = None if b.key_block is None else rebuild(b.key_block)
        return Block(data, b.type, valid, b.dict_id, lengths=lengths, elem_valid=ev,
                     key_block=key)

    blocks = tuple(rebuild(b) for b in page.blocks)
    return Page(blocks, page.names, torch.tensor(n, dtype=torch.int32)), copies


# ---------------------------------------------------------------------------
# serialize
# ---------------------------------------------------------------------------


def serialize_page(
    page: Page,
    cache: Optional[DictionaryCache] = None,
    compress: bool = True,
    caps: Optional[dict] = None,
    stats: Optional[WireStats] = None,
    compress_once: bool = True,
) -> bytes:
    """Page -> bytes, live rows only.

    `caps` is the capability set negotiated for the receiving fleet (see
    `negotiate`); None means a peer like this process. Version-1 peers get
    the PTP1 frame, version-2 peers the per-buffer encodings and the
    striped frame. A v2 body the encodings already shrank below
    _SKIP_CODEC_RATIO of its logical bytes skips the codec, unless
    `compress_once` is False (a check of each codec on such a page)."""
    t0 = time.perf_counter()
    if caps is None:
        caps = local_capabilities()
    v2 = int(caps.get("version", 1)) >= 2
    n = int(page.count)
    copies = 0 if page.device.type == "cpu" else 1  # the count just read
    tensors: List[torch.Tensor] = []
    for b in page.blocks:
        tensors.extend(_block_tensors(b, n))
    arrays, fetched = _fetch_host(tensors)
    copies += fetched
    arrays_iter = iter(arrays)
    cols = []
    fixups = []  # (entry, [array indices]) to fill encoding descriptors
    dict_payloads = {}
    raw_logical = sum(a.nbytes for a in arrays)
    counter = iter(range(len(arrays)))

    unsorted: List[str] = []  # dictionaries whose entries are not in order

    def encode_block(name, b):
        data = next(arrays_iter)
        idxs = [next(counter)]
        dict_id = b.dict_id
        entry = {
            "name": name,
            "type": b.type.display(),
            "dtype": data.dtype.str,
            "shape": list(data.shape),
            "valid": b.valid is not None,
            "dict_id": dict_id,
            "lengths": b.lengths is not None,
            "elem_valid": b.elem_valid is not None,
        }
        sketch = getattr(b.type, "sketch", None)
        if sketch is not None:
            entry["sketch"] = sketch  # no SQL spelling carries it
        if dict_id is not None and (cache is None or dict_id not in cache.sent):
            dict_payloads[str(dict_id)] = _dictionary_entries(dict_id)
            if not getattr(dictionary_by_id(dict_id), "is_sorted", True):
                unsorted.append(str(dict_id))
            if cache is not None:
                cache.sent.add(dict_id)
        for present in (b.valid, b.lengths, b.elem_valid):
            if present is not None:
                next(arrays_iter)
                idxs.append(next(counter))
        fixups.append((entry, idxs))
        if b.key_block is not None:
            entry["key"] = encode_block(f"{name}$keys", b.key_block)
        return entry

    for name, b in zip(page.names, page.blocks):
        cols.append(encode_block(name, b))

    encs: List[str] = []
    if v2:
        # per-buffer encodings, fanned out on the stripe pool
        pool = _stripe_pool()
        big = raw_logical >= (1 << 20)
        if pool is not None and big and len(arrays) > 1:
            encoded = list(pool.map(_encode_array, arrays))
        else:
            encoded = [_encode_array(a) for a in arrays]
        payloads = []
        descs_by_idx: List[Optional[dict]] = []
        for desc, payload in encoded:
            descs_by_idx.append(desc)
            payloads.append(payload)
            if desc is not None:
                encs.append(desc["k"])
        for entry, idxs in fixups:
            descs = [descs_by_idx[i] for i in idxs]
            if any(d is not None for d in descs):
                entry["enc"] = descs
    else:
        payloads = [np.ascontiguousarray(a) for a in arrays]

    head = {"count": n, "columns": cols, "dictionaries": dict_payloads}
    if unsorted:
        head["unsorted_dictionaries"] = unsorted  # the JAX package ignores it
    header = json.dumps(head).encode()
    parts: List[bytes] = [len(header).to_bytes(4, "little"), header]
    for buf in payloads:
        nbytes = buf.nbytes if isinstance(buf, np.ndarray) else len(buf)
        parts.append(nbytes.to_bytes(8, "little"))
        parts.append(buf.data if isinstance(buf, np.ndarray) else buf)
    raw = b"".join(parts)
    raw_logical += len(header)

    if v2:
        # compress once: a body the encodings already shrank well below
        # its logical bytes skips the general codec
        already_compact = compress_once and len(raw) < raw_logical * _SKIP_CODEC_RATIO
        codec = "raw" if not compress or already_compact else _pick_codec(caps)
        out = _frame_v2(raw, codec)
    else:
        out = _serialize_v1_tail(raw, caps if compress else {"codecs": ["raw"]})
        encs = []
    if stats is not None:
        stats.record_encode(raw_logical, len(out), time.perf_counter() - t0, encs, copies)
    return out


def _serialize_v1_tail(raw: bytes, caps: Optional[dict]) -> bytes:
    """PTP1: the unencoded body under one codec byte, within the
    negotiated codec set."""
    codec = _pick_codec(caps)
    if codec == "zstd":
        packed = _zstd_compress(raw)
        if len(packed) < len(raw):
            return _MAGIC + b"\x03" + packed
    elif codec == "lz4":
        packed = native.lz4_compress(raw)
        if len(packed) + 8 < len(raw):
            return _MAGIC + b"\x02" + len(raw).to_bytes(8, "little") + packed
    elif codec == "zlib":
        packed = zlib.compress(raw, 1)
        if len(packed) < len(raw):
            return _MAGIC + b"\x01" + packed
    return _MAGIC + b"\x00" + raw


# ---------------------------------------------------------------------------
# deserialize
# ---------------------------------------------------------------------------


def deserialize_page(data: bytes, cache: Optional[DictionaryCache] = None,
                     stats: Optional[WireStats] = None, device="cuda") -> Page:
    """bytes -> Page on the receiver's `device` (the card unless the caller
    passes the CPU). A malformed frame raises ValueError."""
    t0 = time.perf_counter()
    device = torch.device(device)
    magic = bytes(data[:4])
    if magic == _MAGIC2:
        raw = _deframe_v2(data)
    elif magic == _MAGIC:
        raw = _deframe_v1(data)
    else:
        raise ValueError("bad page magic")
    page, copies = _decode_body(raw, cache, device)
    if stats is not None:
        stats.record_decode(len(data), time.perf_counter() - t0, copies)
    return page


def _deframe_v1(data: bytes) -> bytes:
    if len(data) < 5:
        raise ValueError("truncated PTP1 frame")
    codec = data[4]
    if codec == 0:
        return data[5:]
    if codec == 1:
        # untrusted input: bound the inflated size by the page cap (a zlib
        # bomb expands ~1000x, so a ratio bound would refuse real pages)
        d = zlib.decompressobj()
        raw = d.decompress(data[5:], MAX_PAGE_BYTES)
        if d.unconsumed_tail:
            raise ValueError(f"zlib page exceeds the {MAX_PAGE_BYTES}-byte page cap")
        return raw
    if codec == 2:
        orig = int.from_bytes(data[5:13], "little")
        # the size header is untrusted: bound it before allocating
        if orig > max(256 * (len(data) - 13), 1 << 12) or orig > MAX_PAGE_BYTES:
            raise ValueError(f"lz4 page declares implausible size {orig} "
                             f"for {len(data) - 13} compressed bytes")
        return native.lz4_decompress(data[13:], orig)
    if codec == 3:
        return _zstd_decompress(data[5:], MAX_PAGE_BYTES)
    raise ValueError(f"unknown page codec {codec}")


def _decode_body(raw: bytes, cache: Optional[DictionaryCache], device):
    view = memoryview(raw)
    if len(view) < 4:
        raise ValueError("truncated page body")
    hlen = int.from_bytes(view[:4], "little")
    if 4 + hlen > len(view):
        raise ValueError("page header runs past the body")
    header = json.loads(bytes(view[4:4 + hlen]))
    off = 4 + hlen

    def read_buf():
        nonlocal off
        if off + 8 > len(view):
            raise ValueError("truncated page buffer")
        blen = int.from_bytes(view[off:off + 8], "little")
        off += 8
        if off + blen > len(view):
            raise ValueError("page buffer runs past the body")
        buf = view[off:off + blen]
        off += blen
        return buf

    n = int(header["count"])
    unsorted = set(header.get("unsorted_dictionaries") or ())
    # cumulative materialization cap across all of the page's buffers
    budget = {"left": MAX_PAGE_BYTES}
    arrays: List[np.ndarray] = []
    specs = []  # per column, a nested spec of array indices

    def take(arr: np.ndarray) -> int:
        arrays.append(arr)
        return len(arrays) - 1

    def decode_block(col):
        typ = T.parse_type(col["type"])
        if col.get("sketch") is not None and isinstance(typ, T.ArrayType):
            typ = T.ArrayType(typ.element, sketch=col["sketch"])
        encs = col.get("enc") or [None] * 4
        ei = iter(encs)
        dtype = np.dtype(col["dtype"])
        shape = col["shape"]
        spec = {"type": typ,
                "data": take(_decode_array(next(ei, None), read_buf(), dtype, shape, budget))}
        if col["valid"]:
            spec["valid"] = take(_decode_array(next(ei, None), read_buf(), np.dtype(np.bool_),
                                               (shape[0],), budget))
        if col.get("lengths"):
            spec["lengths"] = take(_decode_array(next(ei, None), read_buf(), np.dtype(np.int32),
                                                 (shape[0],), budget))
        if col.get("elem_valid"):
            spec["elem_valid"] = take(_decode_array(next(ei, None), read_buf(),
                                                    np.dtype(np.bool_), shape[:2], budget))
        dict_id = col["dict_id"]
        if dict_id is not None:
            payload = header["dictionaries"].get(str(dict_id))
            if payload is not None:
                local = intern_dictionary(
                    UnsortedEntries(payload) if str(dict_id) in unsorted else tuple(payload))
                if cache is not None:
                    cache.remote_to_local[dict_id] = local
                spec["dict"] = local
            elif cache is not None and dict_id in cache.remote_to_local:
                spec["dict"] = cache.remote_to_local[dict_id]
            else:
                raise ValueError(f"dictionary {dict_id} neither in the payload nor cached")
        if col.get("key") is not None:
            spec["key"] = decode_block(col["key"])
        return spec

    names = []
    for col in header["columns"]:
        specs.append(decode_block(col))
        names.append(col["name"])
    tensors, count, copies = _to_device(arrays, n, device)

    def build(spec) -> Block:
        get = lambda k: None if k not in spec else tensors[spec[k]]  # noqa: E731
        return Block(tensors[spec["data"]], spec["type"], get("valid"), spec.get("dict"),
                     lengths=get("lengths"), elem_valid=get("elem_valid"),
                     key_block=None if "key" not in spec else build(spec["key"]))

    page = Page(tuple(build(s) for s in specs), tuple(names), count)
    return page, copies
