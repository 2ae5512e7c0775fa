"""The port's page wire (presto_tpu_torch/server/serde.py) and its LZ4 codec
(presto_tpu_torch/native/), on the CPU.

* Round trips of every type the port has (integers, doubles, reals,
  booleans, short and long decimals, dates, timestamps, varchar with NULLs
  and dictionaries, arrays with NULL elements, maps) under PTP1 and PTP2
  and every codec, at a size below the encodings' threshold and above it.
* Across packages, both ways: the port's frames read by
  presto_tpu.server.serde.deserialize_page, and the JAX package's frames
  read by the port, with equal rows; the LZ4 blocks of the two native/
  copies read by each other (and by the JAX package's Python decoder).
* DictionaryCache ships a dictionary once; `negotiate` with a peer that
  lacks lz4, v2 or any advert; corrupt frames raise before they allocate
  (MAX_PAGE_BYTES, MAX_STRIPES); a failed LZ4 build raises at the first
  LZ4 call and never turns into zlib; the library builds into _build/.
"""

import json
import math

import numpy as np
import pytest
import torch

from presto_tpu import native as ref_native
from presto_tpu.server import serde as ref_serde
from presto_tpu_torch import native
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.page import Page
from presto_tpu_torch.server import serde
from presto_tpu_torch.server.serde import (
    DictionaryCache,
    WireStats,
    deserialize_page,
    local_capabilities,
    negotiate,
    serialize_page,
)
from presto_tpu_torch.session import Session

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_stripe_threads_left():
    """The stripe pool's threads stop with the module."""
    yield
    serde.shutdown_stripe_pool()

# every storage type and companion of the port's blocks, over `nation`
# (25 rows) grouped by region (5 rows). Its strings are not n_name: both
# packages' generators hold the nation names as numpy strings, and the JAX
# package's reader interns what it reads process-wide, so reading them here
# as Python strings would change the string type of every later nation
# name in the process (interned tuples compare equal across both)
TYPES_SQL = """select n_regionkey, array_agg(r_name) a,
 array_agg(case when n_nationkey % 3 = 0 then null else n_nationkey end) b,
 map_agg(n_nationkey, r_name) m,
 sum(cast(n_nationkey as decimal(38,2))) ld,
 min(cast(n_nationkey as decimal(10,2))) sd, max(date '1995-01-01') d,
 max(timestamp '1995-01-01 10:11:12') ts, count(*) c, max(cast(n_nationkey as double)) f,
 max(cast(n_nationkey as real)) r, min(n_nationkey = 3) bo,
 max(case when n_regionkey = 2 then null else n_comment end) s
 from nation join region on n_regionkey = r_regionkey
 group by n_regionkey order by n_regionkey"""
# above the encodings' 64-element threshold: every encoding path
WIDE_SQL = """select l_orderkey, l_linenumber, l_quantity, l_extendedprice, l_discount,
 l_returnflag, l_shipdate, l_shipmode, l_comment,
 case when l_linenumber = 2 then null else l_tax end tax,
 cast(l_extendedprice as decimal(38,2)) * 3 big, l_orderkey % 7 = 0 flag,
 cast(l_discount as double) dd, cast(l_discount as real) rr
 from lineitem where l_orderkey < 600 order by l_orderkey, l_linenumber"""

V1 = [{"version": 1, "codecs": [c, "raw"]} for c in ("raw", "zlib", "lz4", "zstd")]
V2 = [{"version": 2, "codecs": [c, "raw"]} for c in ("raw", "zlib", "lz4", "zstd")]
CAPS = V1 + V2
CAP_IDS = [f"v{c['version']}-{c['codecs'][0]}" for c in CAPS]
CODEC_IDS = {"raw": 0, "zlib": 1, "lz4": 2, "zstd": 3}


def _codec_id(caps):
    """The codec byte a frame under `caps` carries when its codec ran
    (zstd only where zstandard imports)."""
    codec = caps["codecs"][0]
    return CODEC_IDS[codec if codec in local_capabilities()["codecs"] else "raw"]


@pytest.fixture(scope="module")
def pages():
    sess = Session(TpchCatalog(0.01, device="cpu"), device="cpu", result_cache=False)
    return {"types": sess.query(TYPES_SQL).page, "wide": sess.query(WIDE_SQL).page}


def _norm(v):
    """A package-neutral spelling of one value (numpy scalars, dates and
    decimals by their text; maps as sorted pairs; NaN as one token)."""
    if v is None:
        return None
    if isinstance(v, dict):
        return tuple(sorted((_norm(k), _norm(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, (float, np.floating)) and math.isnan(float(v)):
        return "nan"
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    return str(v)


def _rows(page):
    return [_norm(r) for r in page.to_pylist()]


@pytest.mark.parametrize("which", ["types", "wide"])
@pytest.mark.parametrize("caps", CAPS, ids=CAP_IDS)
def test_roundtrip_every_type(pages, which, caps):
    page = pages[which]
    # the codec runs even where the encodings alone made the body compact
    data = serialize_page(page, caps=caps, compress_once=False)
    assert data[:4] == (b"PTP2" if caps["version"] == 2 else b"PTP1")
    assert data[4] == _codec_id(caps)
    out = deserialize_page(data, device="cpu")
    assert out.device == torch.device("cpu")
    assert _rows(out) == _rows(page)
    for a, b in zip(page.blocks, out.blocks):
        assert a.type == b.type
        assert (a.lengths is None) == (b.lengths is None)
        assert (a.key_block is None) == (b.key_block is None)


@pytest.mark.parametrize("which", ["types", "wide"])
@pytest.mark.parametrize("caps", CAPS, ids=CAP_IDS)
def test_port_frames_read_by_the_jax_package(pages, which, caps):
    page = pages[which]
    data = serialize_page(page, caps=caps, compress_once=False)
    assert data[4] == _codec_id(caps)
    assert _rows(ref_serde.deserialize_page(data)) == _rows(page)


@pytest.mark.parametrize("which", ["types", "wide"])
@pytest.mark.parametrize("caps", CAPS, ids=CAP_IDS)
def test_jax_package_frames_read_by_the_port(pages, which, caps, monkeypatch):
    # a page of the JAX package (its own decoder built it), serialized by
    # the JAX package under the same capabilities, its codec run even on a
    # compact body (the JAX package's serialize_page has no argument for
    # that, so its module setting is patched for this test)
    monkeypatch.setattr(ref_serde, "_SKIP_CODEC_RATIO", 0.0)
    ref_page = ref_serde.deserialize_page(serialize_page(pages[which]))
    data = ref_serde.serialize_page(ref_page, caps=caps)
    assert data[4] == _codec_id(caps)
    assert _rows(deserialize_page(data, device="cpu")) == _rows(ref_page)


def test_lazy_dictionary_crosses_both_ways():
    """A TPC-H page whose c_name is a lazy dictionary ships its entries."""
    page = TpchCatalog(0.01, device="cpu").page("customer")
    page = Page(page.blocks[:3], page.names[:3], page.count)
    ref_page = ref_serde.deserialize_page(serialize_page(page))
    assert _rows(ref_page) == _rows(page)
    back = deserialize_page(ref_serde.serialize_page(ref_page), device="cpu")
    assert _rows(back) == _rows(page)


@pytest.mark.parametrize("size", [1, 17, 4096, 70_000, 1 << 20])
@pytest.mark.parametrize("kind", ["text", "random"])
def test_lz4_blocks_cross_both_ways(size, kind):
    rng = np.random.default_rng(size)
    if kind == "random":
        data = rng.integers(0, 256, size, np.uint8).tobytes()
    else:
        data = (b"the quick brown fox %d " * (size // 20 + 1))[:size]
    ours = native.lz4_compress(data)
    theirs = ref_native.lz4_compress(data)
    assert ref_native.lz4_decompress(ours, size) == data
    assert ref_native._py_lz4_decompress(ours) == data
    assert native.lz4_decompress(theirs, size) == data
    assert native.lz4_decompress(ours, size) == data


def test_lz4_library_builds_into_build_dir():
    path = native.library_path()
    assert native.available() and path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == "presto_tpu_torch"
    assert not list(path.parent.parent.joinpath("native").glob("*.so"))


def test_failed_lz4_build_raises_at_first_call(pages, monkeypatch):
    """No quiet drop to zlib: a negotiated lz4 frame with no codec raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "g++ not found")
    with pytest.raises(native.NativeCodecError, match="g.. not found"):
        native.lz4_compress(b"x" * 100)
    with pytest.raises(native.NativeCodecError):
        serialize_page(pages["wide"], caps={"version": 1, "codecs": ["lz4", "zlib", "raw"]})
    frame = ref_serde.serialize_page(ref_serde.deserialize_page(serialize_page(pages["wide"])),
                                     caps={"version": 1, "codecs": ["lz4", "raw"]})
    assert frame[4] == 2
    with pytest.raises(native.NativeCodecError):
        deserialize_page(frame, device="cpu")
    # lz4 stays advertised: the build is expected, its failure surfaces
    assert "lz4" in local_capabilities()["codecs"]


def test_dictionary_cache_ships_once():
    page = Page.from_dict({"s": ["x", "y", "x"]}, device="cpu")
    tx, rx = DictionaryCache(), DictionaryCache()
    first = serialize_page(page, cache=tx)
    second = serialize_page(page, cache=tx)
    assert len(second) < len(first)
    a = deserialize_page(first, cache=rx, device="cpu").to_pylist()
    b = deserialize_page(second, cache=rx, device="cpu").to_pylist()
    assert a == b == [("x",), ("y",), ("x",)]
    with pytest.raises(ValueError, match="dictionary"):
        deserialize_page(second, device="cpu")  # no cache: the id is unknown


def test_negotiate_with_peers_lacking_lz4_v2_or_adverts(pages):
    ours = local_capabilities()
    assert ours["version"] == 2 and "lz4" in ours["codecs"] and ours["dict_cache"]
    no_lz4 = negotiate([ours, {"version": 2, "codecs": ["zlib", "raw"]}])
    assert no_lz4["codecs"] == ["zlib", "raw"] and "hier" not in no_lz4
    assert serde._pick_codec(no_lz4) == "zlib"
    v1 = negotiate([ours, {"version": 1, "codecs": ["lz4", "zlib", "raw"],
                           "hier": {"ragged": True}, "dict_cache": True}])
    assert v1["version"] == 1 and v1["hier"] == {"ragged": True} and v1["dict_cache"]
    data = serialize_page(pages["wide"], caps=v1)
    assert data[:4] == b"PTP1" and data[4] == 2  # lz4
    assert _rows(ref_serde.deserialize_page(data)) == _rows(pages["wide"])
    silent = negotiate([ours, None])
    assert silent == {"version": 1, "codecs": ["lz4", "zlib", "raw"]}
    # the JAX package's advert has no dict_cache: per-page dictionaries
    mixed = negotiate([ours, ref_serde.local_capabilities()])
    assert "dict_cache" not in mixed and mixed["hier"] == {"ragged": True}


def _stripe_frame(codec, stripes):
    out = serde._MAGIC2 + bytes([codec]) + len(stripes).to_bytes(4, "little")
    for orig, blob in stripes:
        out += orig.to_bytes(4, "little") + len(blob).to_bytes(4, "little")
    for _orig, blob in stripes:
        out += blob
    return out


def _body_frame(header: dict, bufs):
    h = json.dumps(header).encode()
    raw = len(h).to_bytes(4, "little") + h
    for b in bufs:
        raw += len(b).to_bytes(8, "little") + b
    return (serde._MAGIC2 + b"\x00" + (1).to_bytes(4, "little") + len(raw).to_bytes(4, "little")
            + len(raw).to_bytes(4, "little") + raw)


CORRUPT = {
    "stripe_count": (serde._MAGIC2 + b"\x02" + (1 << 31).to_bytes(4, "little"), "stripe count"),
    "no_stripes": (serde._MAGIC2 + b"\x00" + (0).to_bytes(4, "little"), "stripe count"),
    "past_page_cap": (_stripe_frame(0, [(serde.MAX_PAGE_BYTES + 1, b"\x00" * 16)]), "page cap"),
    "inflation": (_stripe_frame(2, [((1 << 25), b"\x00" * 64)]), "implausible"),
    "short_stripe": (_stripe_frame(0, [(32, b"\x00" * 8)]), "unexpected size"),
    "payload_missing": (_stripe_frame(0, [(8, b"\x00" * 8)])[:-4], "length mismatch"),
    "truncated_table": (serde._MAGIC2 + b"\x00" + (4).to_bytes(4, "little") + b"\x00" * 8,
                        "truncated stripe header"),
    "unknown_codec": (_stripe_frame(9, [(8, b"\x00" * 8)]), "unknown page codec"),
    "bad_magic": (b"NOPE" + b"\x00" * 16, "bad page magic"),
    "v1_lz4_size": (serde._MAGIC + b"\x02" + (1 << 40).to_bytes(8, "little") + b"\x00" * 8,
                    "implausible size"),
    "column_past_cap": (_body_frame(
        {"count": 8, "dictionaries": {}, "columns": [{
            "name": "a", "type": "bigint", "dtype": "<i8", "shape": [1 << 40], "valid": False,
            "dict_id": None, "lengths": False, "elem_valid": False,
            "enc": [{"k": "const"}]}]}, [b"\x00" * 8]), "page cap"),
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_frames_raise(case):
    data, match = CORRUPT[case]
    with pytest.raises(ValueError, match=match):
        deserialize_page(data, device="cpu")


def test_many_columns_past_the_cap_together(monkeypatch):
    """Per-column legal shapes that sum past MAX_PAGE_BYTES raise before
    any of them is materialized."""
    monkeypatch.setattr(serde, "MAX_PAGE_BYTES", 1 << 20)
    cols = [{"name": f"c{i}", "type": "bigint", "dtype": "<i8", "shape": [(1 << 20) // 8 - 8],
             "valid": False, "dict_id": None, "lengths": False, "elem_valid": False,
             "enc": [{"k": "const"}]} for i in range(20)]
    with pytest.raises(ValueError, match="page cap"):
        deserialize_page(_body_frame({"count": 8, "columns": cols, "dictionaries": {}},
                                     [b"\x00" * 8] * 20), device="cpu")


def test_multi_stripe_frames_and_wire_stats(pages, monkeypatch):
    monkeypatch.setattr(serde, "_STRIPE_BYTES", 1 << 12)
    stats = WireStats()
    data = serialize_page(pages["wide"], caps={"version": 2, "codecs": ["lz4", "raw"]},
                          stats=stats, compress_once=False)
    assert data[4] == 2 and int.from_bytes(data[5:9], "little") > 1
    out = deserialize_page(data, stats=stats, device="cpu")
    assert _rows(out) == _rows(pages["wide"])
    snap = stats.snapshot()
    assert snap["pages"] == snap["decoded_pages"] == 1
    assert snap["compression_ratio"] > 1 and snap["encodings"]
    # pages on the CPU cross no device boundary
    assert snap["d2h_copies"] == snap["h2d_copies"] == 0


@pytest.fixture(scope="module")
def lineitem_keys():
    return TpchCatalog(0.01, device="cpu").page("lineitem").select(
        ["l_orderkey", "l_linenumber", "l_quantity", "l_shipdate", "l_returnflag"])


@pytest.mark.parametrize("codec", ["zlib", "lz4"])
def test_compact_v2_body_skips_the_codec(lineitem_keys, codec):
    """Compress once: the encoded body of lineitem's keys, dates and flags
    is below _SKIP_CODEC_RATIO of its logical bytes, so by default the
    frame is raw; with compress_once=False the named codec runs and
    shrinks it further."""
    page = lineitem_keys
    caps = {"version": 2, "codecs": [codec, "raw"]}
    stats = WireStats()
    compact = serialize_page(page, caps=caps, stats=stats)
    assert compact[4] == 0
    assert len(compact) < stats.snapshot()["raw_bytes"] * serde._SKIP_CODEC_RATIO
    packed = serialize_page(page, caps=caps, compress_once=False)
    assert packed[4] == CODEC_IDS[codec] and len(packed) < len(compact)
    for data in (compact, packed):
        out = deserialize_page(data, device="cpu")
        assert int(out.count) == int(page.count)
        for a, b in zip(page.blocks, out.blocks):
            assert torch.equal(a.data[:int(page.count)], b.data[:int(page.count)])
            assert (a.dictionary is None) == (b.dictionary is None)
            if a.dictionary is not None:
                assert list(a.dictionary) == list(b.dictionary)


def test_unsorted_dictionary_stays_unsorted_across_the_wire():
    """A fault of the JAX package's wire (ROADMAP queue 3): a lazy
    dictionary whose entries are not in string order (TPC-H phones) is
    received as a plain tuple, which both packages take for sorted, so a
    comparison on the receiver orders codes, not strings. The port's
    frames carry the mark and its receiver keeps the dictionary unsorted
    (and the JAX package's reader ignores the mark)."""
    page = TpchCatalog(0.01, device="cpu").page("customer").select(["c_custkey", "c_phone"])
    assert not page.blocks[1].dictionary.is_sorted
    data = serialize_page(page)
    ours = deserialize_page(data, device="cpu").blocks[1].dictionary
    assert ours.is_sorted is False and list(ours) == list(page.blocks[1].dictionary)
    theirs = ref_serde.deserialize_page(data).blocks[1].dictionary
    assert isinstance(theirs, tuple) and list(theirs) != sorted(theirs)
