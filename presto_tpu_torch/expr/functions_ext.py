"""Scalar function breadth — the registry's long tail (torch counterpart of
presto_tpu/expr/functions_ext.py, its scalar part).

Families mirroring the reference's FunctionRegistry.java:360 registrations
(operator/scalar/MathFunctions.java, StringFunctions.java,
VarbinaryFunctions.java, HmacFunctions.java, JsonFunctions.java,
BitwiseFunctions.java, DateTimeFunctions.java, ColorFunctions.java ...):
numeric functions are elementwise tensor operations on the page's device;
varchar functions evaluate once per DICTIONARY entry on the host and remap
codes with one device gather (functions.py `_dict_transform`). Binary-typed
functions (md5/sha/base64/hex) operate on the utf8 bytes of varchar values
and return lowercase-hex / base64 varchar — the engine has no VARBINARY
column type, so the digest surface is exposed at the string layer, as in
the JAX package.

Zero-argument functions (e(), pi(), now(), ...) return a 0-d tensor with
its `literal`; the compiler broadcasts it to the page's capacity.

Array and map functions work on (capacity, width) element tensors with
per-row lengths (functions.py); geometry values are ARRAY(DOUBLE) vertex
lanes (ops/geometry.py); the `*_cdf` family uses torch.special where it has
the function and a regularized incomplete beta written here where it does
not.

Imported for its registration side effects at the bottom of functions.py.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as _hmac
import json
import math
import re
import struct
import time
import unicodedata
import zlib
from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..page import to_tensor
from .functions import (
    _STRFTIME_SPECS,
    _TS_US,
    FUNCTIONS,
    Val,
    _alias,
    _bigint_infer,
    _bool_infer,
    _date_format_table,
    _days_of,
    _dict_predicate,
    _dict_table,
    _dict_table_nullable,
    _dict_transform,
    _dict_transform_nullable,
    _double_infer,
    _format_days,
    _json_get,
    _json_loads,
    _json_path_steps,
    _require_literal,
    _strptime_micros,
    _to_double,
    _unary_double,
    _varchar_infer,
    and_valid,
    array_in_bounds,
    array_lengths,
    dict_split_val,
    intern_dictionary,
    lane_compaction,
    register,
    require_sorted_dict,
    shift_right_logical,
    unify_dictionaries,
)

# ---------------------------------------------------------------------------
# math tail (reference MathFunctions.java)
# ---------------------------------------------------------------------------

_unary_double("expm1", torch.expm1)
_unary_double("log1p", torch.log1p)
_unary_double("asinh", torch.asinh)
_unary_double("acosh", torch.acosh)
_unary_double("atanh", torch.atanh)
_unary_double("cot", lambda x: torch.cos(x) / torch.sin(x))


def _constant(name: str, value: float):
    @register(name, _double_infer)
    def _f(out_type: T.Type) -> Val:
        return Val(torch.tensor(value, dtype=torch.float64), None, T.DOUBLE, literal=value)

    return _f


_constant("e", math.e)
_constant("pi", math.pi)
_constant("infinity", math.inf)
_constant("nan", math.nan)


def _literal_varchar(like: Val, s: str, valid=None) -> Val:
    """A one-entry varchar constant shaped like `like`'s rows."""
    return Val(torch.zeros(like.data.shape[:1], dtype=torch.int32, device=like.device),
               valid, T.VARCHAR, intern_dictionary((s,)), literal=s)


@register("to_base", _varchar_infer)
def _to_base(a: Val, radix: Val, out_type: T.Type) -> Val:
    """Integer literal -> digits in base 2..36. Varchar values are
    dictionary-encoded and an integer COLUMN has an unbounded output
    dictionary, so (as in the JAX package) only literal inputs are taken."""
    r = int(_require_literal(radix, "to_base radix"))
    if not (2 <= r <= 36):
        raise ValueError("radix must be in [2, 36]")
    v = _require_literal(a, "to_base value (column inputs unsupported: "
                            "unbounded output dictionary)")
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    neg, n = v < 0, abs(int(v))
    out = ""
    while True:
        out = digits[n % r] + out
        n //= r
        if n == 0:
            break
    return _literal_varchar(a, ("-" if neg else "") + out, a.valid)


@register("from_base", _bigint_infer)
def _from_base(a: Val, radix: Val, out_type: T.Type) -> Val:
    r = int(_require_literal(radix, "from_base radix"))

    def f(s: str):
        try:
            return int(s, r), True
        except ValueError:
            return 0, False

    return _dict_table_nullable(a, f, np.int64, T.BIGINT)


@register("bitwise_logical_shift_right", _bigint_infer)
def _bitwise_logical_shift_right(a: Val, b: Val, out_type: T.Type) -> Val:
    x, s = a.data.to(torch.int64), b.data.to(torch.int64) & 63
    return Val(shift_right_logical(x, s), and_valid(a.valid, b.valid), T.BIGINT)


@register("wilson_interval_lower", _double_infer)
def _wilson_lower(succ: Val, trials: Val, z: Val, out_type: T.Type) -> Val:
    return _wilson(succ, trials, z, -1.0)


@register("wilson_interval_upper", _double_infer)
def _wilson_upper(succ: Val, trials: Val, z: Val, out_type: T.Type) -> Val:
    return _wilson(succ, trials, z, 1.0)


def _wilson(succ: Val, trials: Val, z: Val, side: float) -> Val:
    s, n, zz = _to_double(succ), _to_double(trials), _to_double(z)
    p = s / n
    denom = 1.0 + zz * zz / n
    center = p + zz * zz / (2 * n)
    spread = zz * torch.sqrt(p * (1 - p) / n + zz * zz / (4 * n * n))
    return Val((center + side * spread) / denom,
               and_valid(succ.valid, trials.valid, z.valid), T.DOUBLE)


@register("great_circle_distance", _double_infer)
def _great_circle_distance(lat1: Val, lon1: Val, lat2: Val, lon2: Val,
                           out_type: T.Type) -> Val:
    """Haversine distance in KILOMETERS (reference GeoFunctions.
    greatCircleDistance — same Earth radius constant)."""
    r = 6371.01
    p1, l1 = torch.deg2rad(_to_double(lat1)), torch.deg2rad(_to_double(lon1))
    p2, l2 = torch.deg2rad(_to_double(lat2)), torch.deg2rad(_to_double(lon2))
    h = torch.sin((p2 - p1) / 2) ** 2 + torch.cos(p1) * torch.cos(p2) * torch.sin((l2 - l1) / 2) ** 2
    d = 2 * r * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))
    return Val(d, and_valid(lat1.valid, lon1.valid, lat2.valid, lon2.valid), T.DOUBLE)


# ---------------------------------------------------------------------------
# string tail (reference StringFunctions.java)
# ---------------------------------------------------------------------------

@register("translate", _varchar_infer)
def _translate(a: Val, frm: Val, to: Val, out_type: T.Type) -> Val:
    f = _require_literal(frm, "translate from")
    t = _require_literal(to, "translate to")
    table = {ord(c): (t[i] if i < len(t) else None) for i, c in enumerate(f)}
    return _dict_transform(a, lambda s: s.translate(table))


@register("strrpos", _bigint_infer)
def _strrpos(a: Val, sub: Val, out_type: T.Type) -> Val:
    needle = _require_literal(sub, "strrpos substring")
    return Val(_dict_table(a, lambda s: s.rfind(needle) + 1), a.valid, T.BIGINT)


@register("normalize", _varchar_infer)
def _normalize(a: Val, *rest, out_type: T.Type) -> Val:
    form = (_require_literal(rest[0], "normalize form") if rest else "NFC").upper()
    if form not in ("NFC", "NFD", "NFKC", "NFKD"):
        raise ValueError(f"invalid normalization form {form}")
    return _dict_transform(a, lambda s: unicodedata.normalize(form, s))


@register("concat_ws", _varchar_infer)
def _concat_ws(sep: Val, *vals: Val, out_type: T.Type) -> Val:
    s = _require_literal(sep, "concat_ws separator")
    cat = FUNCTIONS["concat"].impl
    sep_val = _literal_varchar(sep, s)
    out: Optional[Val] = None
    for v in vals:
        out = v if out is None else cat(cat(out, sep_val, out_type=T.VARCHAR), v,
                                         out_type=T.VARCHAR)
    return out if out is not None else sep_val


@register("char2hexint", _varchar_infer)
def _char2hexint(a: Val, out_type: T.Type) -> Val:
    """Teradata compat: hex of the UTF-16BE code units."""

    def f(s: str) -> str:
        b = s.encode("utf-16-be")
        return "".join(format(u, "04X") for u in struct.unpack(f">{len(b) // 2}H", b))

    return _dict_transform(a, f)


@register("word_stem", _varchar_infer)
def _word_stem(a: Val, out_type: T.Type) -> Val:
    """English suffix stripping (Porter step-1 style, as in the JAX
    package; the reference wraps a Snowball stemmer)."""

    def stem(w: str) -> str:
        s = w.lower()
        if len(s) > 4:
            if s.endswith("sses") or s.endswith("ies"):
                return s[:-2]
            if s.endswith("ss"):
                return s
            if s.endswith("s") and not s.endswith("us"):
                return s[:-1]
            if s.endswith("ing") and len(s) > 5:
                return s[:-3]
            if s.endswith("ed"):
                return s[:-2]
        return s

    return _dict_transform(a, stem)


@register("repeat", lambda ts: T.ArrayType(ts[0]))
def _repeat(elem: Val, count: Val, out_type: T.Type) -> Val:
    """repeat(element, n) as an array value."""
    n = int(_require_literal(count, "repeat count"))
    e = elem.data
    width = max(n, 1)
    data = e[:, None].expand(e.shape[0], width)
    ev = None if elem.valid is None else elem.valid[:, None].expand(e.shape[0], width)
    lengths = torch.full((e.shape[0],), n, dtype=torch.int32, device=e.device)
    return Val(data, None, T.ArrayType(elem.type), elem.dict_id, lengths=lengths, elem_valid=ev)


# ---------------------------------------------------------------------------
# digests / encodings over utf8(varchar) (reference VarbinaryFunctions.java,
# HmacFunctions.java — surfaced at the string layer, see module docstring)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_XXH_P1 = 0x9E3779B185EBCA87
_XXH_P2 = 0xC2B2AE3D27D4EB4F
_XXH_P3 = 0x165667B19E3779F9
_XXH_P4 = 0x85EBCA77C2B2AE63
_XXH_P5 = 0x27D4EB2F165667C5


def _rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _xxh_round(acc, lane):
    acc = (acc + lane * _XXH_P2) & _M64
    return (_rotl64(acc, 31) * _XXH_P1) & _M64


def xxhash64(b: bytes, seed: int = 0) -> int:
    """XXH64 of `b` (the algorithm of Presto's xxhash64, seed 0), as an
    unsigned 64-bit int."""
    n, i = len(b), 0
    if n >= 32:
        v = [(seed + _XXH_P1 + _XXH_P2) & _M64, (seed + _XXH_P2) & _M64, seed,
             (seed - _XXH_P1) & _M64]
        while i + 32 <= n:
            for k in range(4):
                v[k] = _xxh_round(v[k], int.from_bytes(b[i + 8 * k : i + 8 * k + 8], "little"))
            i += 32
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) + _rotl64(v[3], 18)) & _M64
        for k in range(4):
            h = ((h ^ _xxh_round(0, v[k])) * _XXH_P1 + _XXH_P4) & _M64
    else:
        h = (seed + _XXH_P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _xxh_round(0, int.from_bytes(b[i : i + 8], "little"))
        h = (_rotl64(h, 27) * _XXH_P1 + _XXH_P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(b[i : i + 4], "little") * _XXH_P1) & _M64
        h = (_rotl64(h, 23) * _XXH_P2 + _XXH_P3) & _M64
        i += 4
    while i < n:
        h ^= (b[i] * _XXH_P5) & _M64
        h = (_rotl64(h, 11) * _XXH_P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _XXH_P2) & _M64
    h ^= h >> 29
    h = (h * _XXH_P3) & _M64
    return h ^ (h >> 32)


def _digest(name: str, fn):
    @register(name, _varchar_infer)
    def _impl(a: Val, out_type: T.Type, _fn=fn) -> Val:
        return _dict_transform(a, lambda s: _fn(s.encode("utf-8")))

    return _impl


_digest("md5", lambda b: hashlib.md5(b).hexdigest())
_digest("sha1", lambda b: hashlib.sha1(b).hexdigest())
_digest("sha256", lambda b: hashlib.sha256(b).hexdigest())
_digest("sha512", lambda b: hashlib.sha512(b).hexdigest())
_digest("crc32", lambda b: format(zlib.crc32(b) & 0xFFFFFFFF, "x"))
_digest("xxhash64", lambda b: format(xxhash64(b), "016x"))
_digest("to_base64", lambda b: base64.b64encode(b).decode("ascii"))
_digest("to_base64url", lambda b: base64.urlsafe_b64encode(b).decode("ascii"))
_digest("to_hex", lambda b: b.hex().upper())


def _decode(name: str, fn):
    @register(name, _varchar_infer)
    def _impl(a: Val, out_type: T.Type, _fn=fn) -> Val:
        def g(s: str):
            try:
                return _fn(s), True
            except Exception:  # noqa: BLE001 - malformed input -> NULL
                return "", False

        return _dict_transform_nullable(a, g)

    return _impl


_decode("from_base64", lambda s: base64.b64decode(s).decode("utf-8"))
_decode("from_base64url", lambda s: base64.urlsafe_b64decode(s).decode("utf-8"))
_decode("from_hex", lambda s: bytes.fromhex(s).decode("utf-8"))


def _hmac_register(name: str, algo):
    @register(name, _varchar_infer)
    def _impl(a: Val, key: Val, out_type: T.Type, _algo=algo) -> Val:
        k = _require_literal(key, f"{name} key").encode("utf-8")
        return _dict_transform(a, lambda s: _hmac.new(k, s.encode("utf-8"), _algo).hexdigest())

    return _impl


_hmac_register("hmac_md5", hashlib.md5)
_hmac_register("hmac_sha1", hashlib.sha1)
_hmac_register("hmac_sha256", hashlib.sha256)
_hmac_register("hmac_sha512", hashlib.sha512)


def _dict_table_gather(a: Val, build, np_dtype, out_t: T.Type, what: str) -> Val:
    """Per-dictionary-entry scalar decode -> device gather by code. `build`
    maps one dictionary string to a Python scalar, raising ValueError (or
    OverflowError) for a malformed entry, which becomes a NULL row."""
    if a.dictionary is None:
        raise TypeError(f"{what} expects a varchar value")

    def f(s: str):
        try:
            return build(s), True
        except (ValueError, OverflowError):
            return 0, False

    return _dict_table_nullable(a, f, np_dtype, out_t)


_SPOOKY_C = 0xDEADBEEFDEADBEEF


def _rot64(x, k):
    return ((x << k) | (x >> (64 - k))) & _M64


def _spooky_short_mix(h):
    for i, r in zip((2, 3, 0, 1) * 3, (50, 52, 30, 41, 54, 48, 38, 37, 62, 34, 5, 36)):
        h[i] = (_rot64(h[i], r) + h[(i + 1) % 4]) & _M64
        h[(i + 2) % 4] ^= h[i]


def _spooky_short_end(h):
    for i, r in zip((3, 0, 1, 2) * 3, (15, 52, 26, 51, 28, 9, 47, 54, 32, 25, 63)):
        h[i] ^= h[(i + 3) % 4]
        h[(i + 3) % 4] = _rot64(h[(i + 3) % 4], r)
        h[i] = (h[i] + h[(i + 3) % 4]) & _M64


def _spooky_mix(data, s):
    for k, r in enumerate((11, 32, 43, 31, 17, 28, 39, 57, 55, 54, 22, 46)):
        s[k] = (s[k] + data[k]) & _M64
        s[(k + 2) % 12] ^= s[(k + 10) % 12]
        s[(k + 11) % 12] ^= s[k]
        s[k] = _rot64(s[k], r)
        s[(k + 11) % 12] = (s[(k + 11) % 12] + s[(k + 1) % 12]) & _M64


# SpookyHash::EndPartial: h[k] += h[k+2]; h[k+3] ^= h[k]; h[k+2] rotates
_SPOOKY_END = tuple((k, (k + 2) % 12, (k + 3) % 12, r) for k, r in zip(
    (11, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10), (44, 15, 34, 21, 38, 33, 10, 13, 38, 53, 42, 54)))


def spooky_hash_v2(b: bytes, seed: int = 0) -> int:
    """Bob Jenkins' SpookyHash V2 of `b` (Hash64 with both seeds `seed`;
    Hash32 is its low 32 bits), the hash of Presto's spooky_hash_v2_*."""
    n = len(b)

    def u64(i):
        return int.from_bytes(b[i : i + 8], "little")

    if n < 192:  # SpookyHash::Short
        h, i, rem = [seed, seed, _SPOOKY_C, _SPOOKY_C], 0, n % 32
        if n > 15:
            for _ in range(n // 32):
                h[2], h[3] = (h[2] + u64(i)) & _M64, (h[3] + u64(i + 8)) & _M64
                _spooky_short_mix(h)
                h[0], h[1] = (h[0] + u64(i + 16)) & _M64, (h[1] + u64(i + 24)) & _M64
                i += 32
            if rem >= 16:
                h[2], h[3] = (h[2] + u64(i)) & _M64, (h[3] + u64(i + 8)) & _M64
                _spooky_short_mix(h)
                i, rem = i + 16, rem - 16
        h[3] = (h[3] + (n << 56)) & _M64
        tail = b[i : i + rem]
        if rem == 0:
            h[2], h[3] = (h[2] + _SPOOKY_C) & _M64, (h[3] + _SPOOKY_C) & _M64
        else:  # the first 8 tail bytes into c, the rest into d
            h[2] = (h[2] + int.from_bytes(tail[:8], "little")) & _M64
            h[3] = (h[3] + int.from_bytes(tail[8:], "little")) & _M64
        _spooky_short_end(h)
        return h[0]
    h = [seed, seed, _SPOOKY_C] * 4
    i = 0
    while i + 96 <= n:
        _spooky_mix([u64(i + 8 * k) for k in range(12)], h)
        i += 96
    last = bytearray(b[i:]) + bytearray(96 - (n - i))
    last[95] = n - i
    h = [(x + int.from_bytes(last[8 * k : 8 * k + 8], "little")) & _M64 for k, x in enumerate(h)]
    for _ in range(3):  # SpookyHash::EndPartial
        for a, c, x, r in _SPOOKY_END:
            h[a] = (h[a] + h[c]) & _M64
            h[x] ^= h[a]
            h[c] = _rot64(h[c], r)
    return h[0]


def _spooky(bits: int):
    def impl(a: Val, out_type: T.Type) -> Val:
        """SpookyHash V2 of the utf8 bytes as a bigint: the 32-bit hash
        unsigned, the 64-bit one as a signed (two's complement) bigint."""

        def build(s):
            h = spooky_hash_v2(s.encode("utf-8"))
            if bits == 32:
                return h & 0xFFFFFFFF
            return h - (1 << 64) if h >> 63 else h

        return _dict_table_gather(a, build, np.int64, T.BIGINT, "spooky_hash")

    return impl


register("spooky_hash_v2_32", _bigint_infer)(_spooky(32))
register("spooky_hash_v2_64", _bigint_infer)(_spooky(64))


@register("to_big_endian_64", _varchar_infer)
def _to_big_endian_64(a: Val, out_type: T.Type) -> Val:
    """bigint literal -> 8-byte big-endian, as 16 hex characters."""
    v = _require_literal(a, "to_big_endian_64 value (column inputs unsupported: "
                            "unbounded output dictionary)")
    return _literal_varchar(a, int(v).to_bytes(8, "big", signed=True).hex().upper(), a.valid)


@register("from_big_endian_64", _bigint_infer)
def _from_big_endian_64(a: Val, out_type: T.Type) -> Val:
    def f(s: str):
        if len(s) != 16:  # exactly 8 bytes (the reference raises on != 8)
            return 0, False
        try:
            return int.from_bytes(bytes.fromhex(s), "big", signed=True), True
        except ValueError:
            return 0, False

    return _dict_table_nullable(a, f, np.int64, T.BIGINT)


def _to_ieee754(name: str, fmt: str):
    @register(name, _varchar_infer)
    def _f(a: Val, out_type: T.Type) -> Val:
        """double literal -> IEEE754 big-endian bytes as hex."""
        v = _require_literal(a, f"{name} value (column inputs unsupported: "
                                "unbounded output dictionary)")
        return _literal_varchar(a, struct.pack(fmt, float(v)).hex().upper(), a.valid)

    return _f


_to_ieee754("to_ieee754_64", ">d")
_to_ieee754("to_ieee754_32", ">f")


def _from_ieee754(name: str, fmt: str):
    @register(name, _double_infer)
    def _f(a: Val, out_type: T.Type) -> Val:
        def build(s):
            try:
                return struct.unpack(fmt, bytes.fromhex(s))[0]
            except struct.error as e:
                raise ValueError(str(e))

        return _dict_table_gather(a, build, np.float64, T.DOUBLE, "from_ieee754")

    return _f


_from_ieee754("from_ieee754_64", ">d")
_from_ieee754("from_ieee754_32", ">f")


@register("to_utf8", _varchar_infer)
def _to_utf8(a: Val, out_type: T.Type) -> Val:
    """VARCHAR -> VARBINARY(utf8): binary rides the string layer, so this
    is the identity projection."""
    return Val(a.data, a.valid, T.VARCHAR, a.dict_id)


@register("from_utf8", _varchar_infer)
def _from_utf8(a: Val, out_type: T.Type) -> Val:
    return Val(a.data, a.valid, T.VARCHAR, a.dict_id)


@register("typeof", _varchar_infer)
def _typeof(a: Val, out_type: T.Type) -> Val:
    return _literal_varchar(a, str(a.type))


# ---------------------------------------------------------------------------
# regex + json tail
# ---------------------------------------------------------------------------


@register("json_size", _bigint_infer)
def _json_size(a: Val, path: Val, out_type: T.Type) -> Val:
    steps = _json_path_steps(_require_literal(path, "JSON path"))

    def f(s: str):
        v, ok = _json_get(s, steps)
        if not ok:
            return 0, False
        return (len(v) if isinstance(v, (dict, list)) else 0), True

    return _dict_table_nullable(a, f, np.int64, T.BIGINT)


@register("is_json_scalar", _bool_infer)
def _is_json_scalar(a: Val, out_type: T.Type) -> Val:
    def p(s: str) -> bool:
        v, ok = _json_loads(s)
        return ok and not isinstance(v, (dict, list))

    return _dict_predicate(a, p)


@register("json_array_get", _varchar_infer)
def _json_array_get(a: Val, idx: Val, out_type: T.Type) -> Val:
    i0 = int(_require_literal(idx, "json_array_get index"))

    def f(s: str):
        v, ok = _json_loads(s)
        if not ok or not isinstance(v, list):
            return "", False
        i = i0 if i0 >= 0 else len(v) + i0
        if not (0 <= i < len(v)):
            return "", False
        e = v[i]
        return (e if isinstance(e, str) else json.dumps(e, separators=(",", ":"))), True

    return _dict_transform_nullable(a, f)


@register("json_parse", _varchar_infer)
def _json_parse(a: Val, out_type: T.Type) -> Val:
    """Validate and canonicalize JSON text (JSON values are canonical
    strings here)."""

    def f(s: str):
        v, ok = _json_loads(s)
        return (json.dumps(v, separators=(",", ":")), True) if ok else ("", False)

    return _dict_transform_nullable(a, f)


@register("url_extract_parameter", _varchar_infer)
def _url_extract_parameter(a: Val, namev: Val, out_type: T.Type) -> Val:
    from urllib.parse import parse_qs, urlparse

    pname = _require_literal(namev, "url parameter name")

    def f(s: str):
        try:
            q = parse_qs(urlparse(s).query, keep_blank_values=True)
        except Exception:  # noqa: BLE001 — unparseable URL -> SQL NULL
            return "", False
        vals = q.get(pname)
        return (vals[0], True) if vals else ("", False)

    return _dict_transform_nullable(a, f)


# ---------------------------------------------------------------------------
# aliases rounding out the reference surface
# ---------------------------------------------------------------------------

_alias("ceiling", "ceil")
_alias("pow", "power")
_alias("char_length", "length")
_alias("character_length", "length")
_alias("lcase", "lower")
_alias("ucase", "upper")
_alias("position", "strpos")
_alias("index", "strpos")  # teradata-functions: index(string, substring)


# ---------------------------------------------------------------------------
# datetime tail (reference DateTimeFunctions.java, presto-teradata-functions)
# ---------------------------------------------------------------------------


@register("to_iso8601", _varchar_infer)
def _to_iso8601(a: Val, out_type: T.Type) -> Val:
    """DATE -> 'YYYY-MM-DD' through date_format's day table."""
    if not isinstance(a.type, T.DateType):
        raise NotImplementedError("to_iso8601 supports DATE values")
    fmt = _literal_varchar(a, "%Y-%m-%d")
    return FUNCTIONS["date_format"].impl(a, fmt, out_type=T.VARCHAR)


@register("to_milliseconds", _bigint_infer)
def _to_milliseconds(a: Val, out_type: T.Type) -> Val:
    """INTERVAL DAY TO SECOND (stored as a day count) -> milliseconds."""
    return Val(a.data.to(torch.int64) * 86_400_000, a.valid, T.BIGINT)


@register("from_iso8601_timestamp", lambda ts: T.TIMESTAMP)
def _from_iso8601_timestamp(a: Val, out_type: T.Type) -> Val:
    """ISO-8601 string -> timestamp (microseconds, UTC)."""
    import datetime as pydt

    def build(s):
        d = pydt.datetime.fromisoformat(s.replace("Z", "+00:00"))
        if d.tzinfo is not None:
            d = d.astimezone(pydt.timezone.utc).replace(tzinfo=None)
        return int((d - pydt.datetime(1970, 1, 1)).total_seconds() * _TS_US)

    return _dict_table_gather(a, build, np.int64, T.TIMESTAMP, "from_iso8601_timestamp")


def _joda_to_strptime(fmt: str) -> str:
    """Joda pattern -> strptime. Repeat-counted letters; '' escapes."""
    letters = {"d": "%d", "D": "%j", "H": "%H", "h": "%I", "m": "%M", "s": "%S",
               "S": "%f", "a": "%p"}
    out = []
    i, n = 0, len(fmt)
    while i < n:
        c = fmt[i]
        if c == "'":  # quoted literal ('' = literal quote)
            if i + 1 < n and fmt[i + 1] == "'":
                out.append("'")
                i += 2
                continue
            j = fmt.index("'", i + 1) if "'" in fmt[i + 1 :] else n
            out.append(fmt[i + 1 : j].replace("%", "%%"))
            i = j + 1
            continue
        if c.isalpha():
            j = i
            while j < n and fmt[j] == c:
                j += 1
            cnt = j - i
            i = j
            if c in ("y", "Y"):
                out.append("%Y" if cnt != 2 else "%y")
            elif c == "M":
                out.append("%m" if cnt <= 2 else ("%b" if cnt == 3 else "%B"))
            elif c == "E":
                out.append("%a" if cnt <= 3 else "%A")
            elif c in letters:
                out.append(letters[c])
            else:
                raise NotImplementedError(f"parse_datetime Joda letter {c!r}")
        else:
            out.append(c.replace("%", "%%"))
            i += 1
    return "".join(out)


@register("parse_datetime", lambda ts: T.TIMESTAMP)
def _parse_datetime(a: Val, fmt: Val, out_type: T.Type) -> Val:
    f = _joda_to_strptime(_require_literal(fmt, "parse_datetime format"))
    return _dict_table_nullable(a, _strptime_micros(f), np.int64, T.TIMESTAMP)


@register("format_datetime", _varchar_infer)
def _format_datetime(a: Val, fmt: Val, out_type: T.Type) -> Val:
    """Joda-pattern formatting of date/timestamp values through a day table
    (date_format's machinery); time-of-day letters on timestamps are
    rejected, as date_format rejects %H/%i/%s."""
    f = _require_literal(fmt, "format_datetime format")
    strp = _joda_to_strptime(f)  # validates letters; %-free = literal
    days = _days_of(a, "format_datetime", ("%H", "%I", "%M", "%S", "%f", "%p"), strp)
    return _format_days(a, days, _date_format_table(strp, _STRFTIME_SPECS, "format_datetime"))


@register("parse_duration", _double_infer)
def _parse_duration(a: Val, out_type: T.Type) -> Val:
    """'3.5m'-style duration strings -> seconds (double)."""
    units = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
             "d": 86400.0}
    pat = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([a-z]+)\s*$")

    def f(s: str):
        m = pat.match(s)
        if not m or m.group(2) not in units:
            return 0.0, False
        return float(m.group(1)) * units[m.group(2)], True

    return _dict_table_nullable(a, f, np.float64, T.DOUBLE)


@register("parse_presto_data_size", _double_infer)
def _parse_presto_data_size(a: Val, out_type: T.Type) -> Val:
    """'2.3MB' -> bytes, as DOUBLE (the reference's DECIMAL(38,0) ladder
    reaches ZB/YB, past int64)."""
    units = {"B": 1.0, "kB": 2.0**10, "MB": 2.0**20, "GB": 2.0**30, "TB": 2.0**40,
             "PB": 2.0**50, "EB": 2.0**60, "ZB": 2.0**70, "YB": 2.0**80}
    pat = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([A-Za-z]+)\s*$")

    def f(s: str):
        m = pat.match(s)
        if not m or m.group(2) not in units:
            return 0.0, False
        return float(m.group(1)) * units[m.group(2)], True

    return _dict_table_nullable(a, f, np.float64, T.DOUBLE)


@register("human_readable_seconds", _varchar_infer)
def _human_readable_seconds(a: Val, out_type: T.Type) -> Val:
    """Seconds (a literal: the output dictionary of a column is unbounded)
    -> '2 days, 3 hours, ...'."""
    secs = int(_require_literal(a, "human_readable_seconds value (column inputs unsupported)"))
    parts = []
    for unit, span in (("week", 604800), ("day", 86400), ("hour", 3600), ("minute", 60),
                       ("second", 1)):
        q, secs = divmod(secs, span)
        if q:
            parts.append(f"{q} {unit}" + ("s" if q != 1 else ""))
    return _literal_varchar(a, ", ".join(parts) if parts else "0 seconds", a.valid)


# -- the session clock: read at evaluation time (the query's start) ---------


@register("current_date", lambda ts: T.DATE)
def _current_date(out_type: T.Type) -> Val:
    import datetime as _dt

    d = (_dt.date.today() - _dt.date(1970, 1, 1)).days
    return Val(torch.tensor(d, dtype=torch.int32), None, T.DATE, literal=d)


@register("now", lambda ts: T.TIMESTAMP)
def _now(out_type: T.Type) -> Val:
    """The current instant as a TIMESTAMP: microseconds since the epoch,
    the unit of every TIMESTAMP value here."""
    us = int(time.time() * _TS_US)
    return Val(torch.tensor(us, dtype=torch.int64), None, T.TIMESTAMP, literal=us)


_alias("current_timestamp", "now")
_alias("localtimestamp", "now")


@register("current_timezone", _varchar_infer)
def _current_timezone(out_type: T.Type) -> Val:
    # the engine runs in UTC (types.py timestamp semantics)
    return Val(torch.tensor(0, dtype=torch.int32), None, T.VARCHAR,
               intern_dictionary(("UTC",)), literal="UTC")


def _zero_offset(name):
    @register(name, _bigint_infer)
    def _f(a: Val, out_type: T.Type) -> Val:
        """Temporal values are UTC here (no session zones): 0."""
        return Val(torch.zeros(a.data.shape[:1], dtype=torch.int64, device=a.device),
                   a.valid, T.BIGINT)

    return _f


_zero_offset("timezone_hour")
_zero_offset("timezone_minute")


# ---------------------------------------------------------------------------
# color / bar rendering (reference ColorFunctions.java)
# ---------------------------------------------------------------------------

_ANSI = {"black": 0, "red": 1, "green": 2, "yellow": 3, "blue": 4, "magenta": 5,
         "cyan": 6, "white": 7}


@register("color", _bigint_infer)
def _color(a: Val, out_type: T.Type) -> Val:
    """Color name or '#rgb' -> packed color code (bigint; the reference has a
    COLOR type)."""

    def f(s: str):
        if s.startswith("#") and len(s) == 4:
            return int(s[1], 16) * 256 + int(s[2], 16) * 16 + int(s[3], 16), True
        c = _ANSI.get(s.lower())
        return (c, True) if c is not None else (0, False)

    return _dict_table_nullable(a, f, np.int64, T.BIGINT)


@register("rgb", _bigint_infer)
def _rgb(r: Val, g: Val, b: Val, out_type: T.Type) -> Val:
    x = (torch.clamp(r.data.to(torch.int64), 0, 255) * 65536
         + torch.clamp(g.data.to(torch.int64), 0, 255) * 256
         + torch.clamp(b.data.to(torch.int64), 0, 255))
    return Val(x, and_valid(r.valid, g.valid, b.valid), T.BIGINT)


@register("bar", _varchar_infer)
def _bar(x: Val, width: Val, out_type: T.Type) -> Val:
    """Fraction -> a bar of `width` cells (a literal fraction: the output
    dictionary of a column is unbounded)."""
    frac = float(_require_literal(x, "bar fraction (column inputs unsupported)"))
    w = int(_require_literal(width, "bar width"))
    n = max(0, min(w, int(round(frac * w))))
    return _literal_varchar(x, "█" * n + " " * (w - n), x.valid)


@register("render", _varchar_infer)
def _render(b: Val, *rest, out_type: T.Type) -> Val:
    """render(boolean) -> ✓ / ✗ (reference ColorFunctions.render)."""
    codes = torch.where(b.data.to(torch.bool), 0, 1).to(torch.int32)
    return Val(codes, b.valid, T.VARCHAR, intern_dictionary(("✓", "✗")))



# ---------------------------------------------------------------------------
# array tail (reference operator/scalar/ArrayFunctions.java and array/*.java)
# ---------------------------------------------------------------------------

_base_reverse = FUNCTIONS["reverse"].impl


@register("reverse", lambda ts: ts[0])
def _reverse(a: Val, out_type: T.Type) -> Val:
    """reverse(array) element reversal; varchar keeps the dictionary
    implementation (the reference has both overloads)."""
    if not isinstance(a.type, T.ArrayType):
        return _base_reverse(a, out_type=out_type)
    w = a.data.shape[1]
    lens = array_lengths(a)
    lane = torch.arange(w, device=a.device)
    idx = torch.clamp(lens[:, None].to(torch.int64) - 1 - lane[None, :], 0, max(w - 1, 0))
    ev = None if a.elem_valid is None else torch.gather(a.elem_valid, 1, idx)
    return Val(torch.gather(a.data, 1, idx), a.valid, a.type, a.dict_id, lengths=lens,
               elem_valid=ev)


def _elem_live(a: Val) -> torch.Tensor:
    """In-bounds, non-NULL elements."""
    live = array_in_bounds(a)
    if a.elem_valid is not None:
        live = live & a.elem_valid
    return live


def _has_null_elem(a: Val) -> torch.Tensor:
    """Rows holding a NULL element."""
    if a.elem_valid is None:
        return torch.zeros(a.data.shape[:1], dtype=torch.bool, device=a.device)
    return (array_in_bounds(a) & ~a.elem_valid).any(dim=1)


def _extreme(a: Val, out_type: T.Type, kind: str) -> Val:
    """array_max / array_min: NULL for an empty array or one holding a
    NULL element (Presto)."""
    live = _elem_live(a)
    x = a.data
    if x.is_floating_point():
        ident = float("-inf") if kind == "max" else float("inf")
    else:
        info = torch.iinfo(x.dtype)
        ident = info.min if kind == "max" else info.max
    x = torch.where(live, x, torch.full_like(x, ident))
    out = x.amax(dim=1) if kind == "max" else x.amin(dim=1)
    valid = and_valid(a.valid, live.any(dim=1), ~_has_null_elem(a))
    return Val(out, valid, out_type, a.dict_id)


@register("array_max", lambda ts: ts[0].element)
def _array_max(a: Val, out_type: T.Type) -> Val:
    if isinstance(a.type.element, T.VarcharType):
        require_sorted_dict(a, "array_max")
    return _extreme(a, out_type, "max")


@register("array_min", lambda ts: ts[0].element)
def _array_min(a: Val, out_type: T.Type) -> Val:
    if isinstance(a.type.element, T.VarcharType):
        require_sorted_dict(a, "array_min")
    return _extreme(a, out_type, "min")


def _sort_key(data: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key: floats through the IEEE754 total-order
    bit trick (signed zeros equal), so the key orders AND compares like the
    values themselves."""
    if data.is_floating_point():
        f = data.to(torch.float64)
        f = torch.where(f == 0.0, 0.0, f)
        b = f.contiguous().view(torch.int64)
        return torch.where(b < 0, (~b) ^ torch.iinfo(torch.int64).min, b)
    return data.to(torch.int64)


def _lane_order(key: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """Per-row order by (class, key): a stable sort by key, then a stable
    sort by the small class tag (0 value, 1 NULL, 2 padding) — no sentinel
    key can collide with a real value."""
    o = torch.argsort(key, dim=1, stable=True)
    return torch.gather(o, 1, torch.argsort(torch.gather(cls, 1, o), dim=1, stable=True))


def _lane_class(a: Val, live: torch.Tensor) -> torch.Tensor:
    return torch.where(live, 0, torch.where(array_in_bounds(a), 1, 2)).to(torch.uint8)


def _distinct_lanes(a: Val, live: torch.Tensor, keep_null: torch.Tensor, out_type) -> Val:
    """The distinct `live` elements of each row in ascending order, then
    one NULL where `keep_null` (Presto's array_distinct keeps one NULL)."""
    key = _sort_key(a.data)
    order = _lane_order(key, (~live).to(torch.uint8))
    sdata = torch.gather(a.data, 1, order)
    skey = torch.gather(key, 1, order)
    slive = torch.gather(live, 1, order)
    first = torch.cat([torch.ones_like(slive[:, :1]), skey[:, 1:] != skey[:, :-1]], dim=1)
    first = first & slive
    pack = lane_compaction(first)
    n_live = first.sum(dim=1, dtype=torch.int32)
    lane = torch.arange(a.data.shape[1], device=a.device)[None, :]
    out = torch.where(lane < n_live[:, None], torch.gather(sdata, 1, pack), 0)
    lens = n_live + keep_null.to(torch.int32)
    ev = None
    if a.elem_valid is not None:
        ev = lane < n_live[:, None]
    return Val(out, a.valid, out_type, a.dict_id, lengths=lens, elem_valid=ev)


@register("array_distinct", lambda ts: ts[0])
def _array_distinct(a: Val, out_type: T.Type) -> Val:
    return _distinct_lanes(a, _elem_live(a), _has_null_elem(a), out_type)


@register("array_sort", lambda ts: ts[0])
def _array_sort(a: Val, out_type: T.Type) -> Val:
    """Ascending, NULL elements last (Presto)."""
    live = _elem_live(a)
    order = _lane_order(_sort_key(a.data), _lane_class(a, live))
    data = torch.where(torch.gather(live, 1, order), torch.gather(a.data, 1, order), 0)
    ev = None if a.elem_valid is None else torch.gather(live, 1, order)
    return Val(data, a.valid, a.type, a.dict_id, lengths=array_lengths(a), elem_valid=ev)


def _needle_codes(a: Val, needle: Val, what: str) -> torch.Tensor:
    """The needle as a per-row value comparable with the array's elements
    (a varchar literal resolves in the array's dictionary; absent -> -1)."""
    if isinstance(needle.type, T.VarcharType) and needle.dict_id != a.dict_id:
        from .functions import _bisect

        require_sorted_dict(a, what)
        lit = _require_literal(needle, f"{what} needle")
        d = a.dictionary or ()
        code = _bisect(d, lit, "left")
        code = code if code < len(d) and d[code] == lit else -1
        return torch.full(a.data.shape[:1], code, dtype=a.data.dtype, device=a.device)
    nd = needle.data
    return nd.expand(a.data.shape[0]) if nd.ndim == 0 else nd


@register("array_remove", lambda ts: ts[0])
def _array_remove(a: Val, needle: Val, out_type: T.Type) -> Val:
    """Drop the elements equal to the needle; NULL elements stay (Presto)."""
    inb = array_in_bounds(a)
    eq = a.data == _needle_codes(a, needle, "array_remove")[:, None]
    if a.elem_valid is not None:
        eq = eq & a.elem_valid
    keep = inb & ~eq
    order = lane_compaction(keep)
    ev = None if a.elem_valid is None else torch.gather(a.elem_valid, 1, order)
    return Val(torch.gather(a.data, 1, order), and_valid(a.valid, needle.valid), a.type,
               a.dict_id, lengths=keep.sum(dim=1, dtype=torch.int32), elem_valid=ev)


def _pair_codes(a: Val, b: Val):
    """Both arrays' element data in one representation (dictionaries
    unified, dtypes promoted)."""
    da, db, did = a.data, b.data, a.dict_id
    if (a.dict_id is not None or b.dict_id is not None) and a.dict_id != b.dict_id:
        da, db, did = unify_dictionaries(a, b)
    if da.dtype != db.dtype:
        wide = torch.promote_types(da.dtype, db.dtype)
        da, db = da.to(wide), db.to(wide)
    return da, db, did


def _in_other(a: Val, b: Val):
    """(data of a, dict id, a's elements present in b's live elements)."""
    da, db, did = _pair_codes(a, b)
    hit = ((da[:, :, None] == db[:, None, :]) & _elem_live(b)[:, None, :]).any(dim=2)
    return da, did, hit


@register("arrays_overlap", _bool_infer)
def _arrays_overlap(a: Val, b: Val, out_type: T.Type) -> Val:
    """True when a non-NULL element is in both; NULL when none is but
    either holds a NULL element (Presto)."""
    _da, _did, hit = _in_other(a, b)
    any_hit = (hit & _elem_live(a)).any(dim=1)
    some_null = _has_null_elem(a) | _has_null_elem(b)
    return Val(any_hit, and_valid(a.valid, b.valid, any_hit | ~some_null), T.BOOLEAN)


def _set_op(a: Val, b: Val, out_type, keep_fn, null_fn) -> Val:
    da, did, hit = _in_other(a, b)
    masked = Val(da, and_valid(a.valid, b.valid), a.type, did, lengths=array_lengths(a),
                 elem_valid=a.elem_valid)
    keep_null = null_fn(_has_null_elem(a), _has_null_elem(b))
    return _distinct_lanes(masked, keep_fn(_elem_live(a), hit), keep_null, out_type)


@register("array_intersect", lambda ts: ts[0])
def _array_intersect(a: Val, b: Val, out_type: T.Type) -> Val:
    return _set_op(a, b, out_type, lambda la, hit: la & hit, lambda na, nb: na & nb)


@register("array_except", lambda ts: ts[0])
def _array_except(a: Val, b: Val, out_type: T.Type) -> Val:
    return _set_op(a, b, out_type, lambda la, hit: la & ~hit, lambda na, nb: na & ~nb)


@register("array_union", lambda ts: ts[0])
def _array_union(a: Val, b: Val, out_type: T.Type) -> Val:
    da, db, did = _pair_codes(a, b)
    live = torch.cat([_elem_live(a), _elem_live(b)], dim=1)
    merged = Val(torch.cat([da, db], dim=1), and_valid(a.valid, b.valid), a.type, did,
                 lengths=torch.full(da.shape[:1], live.shape[1], dtype=torch.int32,
                                    device=da.device),
                 elem_valid=live)
    return _distinct_lanes(merged, live, _has_null_elem(a) | _has_null_elem(b), out_type)


@register("slice", lambda ts: ts[0])
def _slice(a: Val, start: Val, length: Val, out_type: T.Type) -> Val:
    s0 = int(_require_literal(start, "slice start"))
    ln = int(_require_literal(length, "slice length"))
    w = a.data.shape[1]
    lens = array_lengths(a).to(torch.int64)
    base = torch.full_like(lens, s0 - 1) if s0 > 0 else lens + s0
    lane = torch.arange(w, device=a.device)[None, :]
    idx = base[:, None] + lane
    inb = (idx >= 0) & (idx < lens[:, None]) & (lane < ln)
    idxc = torch.clamp(idx, 0, max(w - 1, 0))
    ev = inb
    if a.elem_valid is not None:
        ev = ev & torch.gather(a.elem_valid, 1, idxc)
    return Val(torch.gather(a.data, 1, idxc), a.valid, a.type, a.dict_id,
               lengths=inb.sum(dim=1, dtype=torch.int32), elem_valid=ev)


@register("array_concat", lambda ts: ts[0])
def _array_concat(a: Val, b: Val, out_type: T.Type) -> Val:
    """ARRAY || ARRAY (reference ArrayConcatFunction): output lane j is a's
    element j while j < len(a), then b's element j - len(a)."""
    if a.data.ndim != 2 or b.data.ndim != 2:
        raise TypeError("array_concat requires array values")
    da, db, did = _pair_codes(a, b)
    wa, wb = da.shape[1], db.shape[1]
    la, lb = array_lengths(a), array_lengths(b)
    j = torch.arange(wa + wb, device=da.device)[None, :]
    from_a = j < la[:, None]
    ia = torch.clamp(j, 0, wa - 1).expand(da.shape[0], -1)
    ib = torch.clamp(j - la[:, None], 0, wb - 1)
    data = torch.where(from_a, torch.gather(da, 1, ia), torch.gather(db, 1, ib))
    ones = lambda x: torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)  # noqa: E731
    eva = ones(da) if a.elem_valid is None else a.elem_valid
    evb = ones(db) if b.elem_valid is None else b.elem_valid
    ev = torch.where(from_a, torch.gather(eva, 1, ia), torch.gather(evb, 1, ib))
    return Val(data, and_valid(a.valid, b.valid), out_type, did, lengths=la + lb,
               elem_valid=ev)


@register("cosine_distance", _double_infer)
def _cosine_distance(a: Val, b: Val, out_type: T.Type) -> Val:
    """1 - cosine similarity of two numeric arrays (reference
    ArrayDistanceFunctions)."""
    if a.lengths is None or b.lengths is None:
        raise TypeError("cosine_distance requires array values")
    x = a.data.to(torch.float64)
    y = b.data.to(torch.float64)
    w = min(x.shape[1], y.shape[1])
    x, y = x[:, :w], y[:, :w]
    inb = torch.arange(w, device=x.device)[None, :] < torch.minimum(a.lengths, b.lengths)[:, None]
    x = torch.where(inb, x, 0.0)
    y = torch.where(inb, y, 0.0)
    num = (x * y).sum(dim=1)
    den = torch.sqrt((x * x).sum(dim=1)) * torch.sqrt((y * y).sum(dim=1))
    return Val(1.0 - num / torch.where(den == 0, 1.0, den), and_valid(a.valid, b.valid, den != 0),
               T.DOUBLE)


# ---------------------------------------------------------------------------
# regex splits + maps (reference RegexpFunctions, MapConcatFunction,
# SplitToMapFunction, CosineSimilarityFunction)
# ---------------------------------------------------------------------------


@register("regexp_split", lambda ts: T.ArrayType(T.VARCHAR))
def _regexp_split(a: Val, patv: Val, out_type: T.Type) -> Val:
    pat = re.compile(_require_literal(patv, "regexp pattern"))
    d = a.dictionary
    if d is None:
        raise TypeError("regexp_split: varchar value lost its dictionary")
    return dict_split_val(a, [pat.split(x) for x in d], "regexp_split")


@register("regexp_extract_all", lambda ts: T.ArrayType(T.VARCHAR))
def _regexp_extract_all(a: Val, patv: Val, *rest, out_type: T.Type) -> Val:
    pat = re.compile(_require_literal(patv, "regexp pattern"))
    group = int(_require_literal(rest[0], "group")) if rest else 0
    d = a.dictionary
    if d is None:
        raise TypeError("regexp_extract_all: varchar value lost its dictionary")
    parts = [[m.group(group) or "" for m in pat.finditer(x)] for x in d]
    return dict_split_val(a, parts, "regexp_extract_all")


@register("map_concat", lambda ts: ts[0])
def _map_concat(a: Val, *rest: Val, out_type: T.Type) -> Val:
    """Union of maps; on duplicate keys the LAST map wins (reference
    MapConcatFunction, variadic)."""
    out = a
    for b in rest:
        out = _map_concat2(out, b)
    return out


def _map_concat2(a: Val, b: Val) -> Val:
    if a.keys is None or b.keys is None:
        raise TypeError("map_concat requires map values")
    kda, kdb, k_did = _pair_codes(a.keys, b.keys)
    vda, vdb, v_did = _pair_codes(a, b)
    wa, wb = kda.shape[1], kdb.shape[1]
    kdata = torch.cat([kda, kdb], dim=1)
    vdata = torch.cat([vda, vdb], dim=1)
    live = torch.cat([array_in_bounds(a), array_in_bounds(b)], dim=1)
    ones = lambda x: torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)  # noqa: E731
    ev = torch.cat([ones(vda) if a.elem_valid is None else a.elem_valid,
                    ones(vdb) if b.elem_valid is None else b.elem_valid], dim=1)
    # kill an entry when any LATER live entry has the same key
    W = wa + wb
    eq = kdata[:, :, None] == kdata[:, None, :]
    lane = torch.arange(W, device=kdata.device)
    later = lane[None, :] > lane[:, None]
    dup = (eq & later[None] & live[:, None, :]).any(dim=2)
    keep = live & ~dup
    order = lane_compaction(keep)
    lens = keep.sum(dim=1, dtype=torch.int32)
    keys = Val(torch.gather(kdata, 1, order), None, a.keys.type, k_did, lengths=lens)
    return Val(torch.gather(vdata, 1, order), and_valid(a.valid, b.valid), a.type, v_did,
               lengths=lens, elem_valid=torch.gather(ev, 1, order), keys=keys)


@register("split_to_map", lambda ts: T.MapType(T.VARCHAR, T.VARCHAR))
def _split_to_map(a: Val, entry_d: Val, kv_d: Val, out_type: T.Type) -> Val:
    """split_to_map('a=1,b=2', ',', '=') — one host parse per dictionary
    entry, padded to the widest entry count (reference SplitToMapFunction)."""
    ed = _require_literal(entry_d, "split_to_map entry delimiter")
    kd = _require_literal(kv_d, "split_to_map key/value delimiter")
    d = a.dictionary
    if d is None:
        raise TypeError("split_to_map expects a varchar value")
    parsed = []
    for x in d:
        pairs = []
        for part in x.split(ed):
            if not part:
                continue
            k, _, v = part.partition(kd)
            pairs.append((k, v))
        parsed.append(pairs)
    width = max((len(p) for p in parsed), default=0) or 1
    keypool = tuple(sorted({k for ps in parsed for k, _v in ps})) or ("",)
    valpool = tuple(sorted({v for ps in parsed for _k, v in ps})) or ("",)
    kidx = {x: i for i, x in enumerate(keypool)}
    vidx = {x: i for i, x in enumerate(valpool)}
    rows = max(len(d), 1)
    kmat = np.zeros((rows, width), np.int32)
    vmat = np.zeros((rows, width), np.int32)
    lens = np.zeros(rows, np.int32)
    for i, ps in enumerate(parsed):
        lens[i] = len(ps)
        for j, (k, v) in enumerate(ps):
            kmat[i, j] = kidx[k]
            vmat[i, j] = vidx[v]
    codes = torch.clamp(a.data.to(torch.int64), 0, rows - 1)
    tab = lambda x: to_tensor(x, torch.int32, a.device)[codes]  # noqa: E731
    klens = tab(lens)
    keys = Val(tab(kmat), None, T.ArrayType(T.VARCHAR), intern_dictionary(keypool),
               lengths=klens)
    return Val(tab(vmat), a.valid, T.MapType(T.VARCHAR, T.VARCHAR), intern_dictionary(valpool),
               lengths=klens, keys=keys)


@register("cosine_similarity", _double_infer)
def _cosine_similarity(a: Val, b: Val, out_type: T.Type) -> Val:
    """cosine_similarity(map(varchar,double), map(varchar,double)) — sparse
    vectors keyed by string (reference CosineSimilarityFunction)."""
    if a.keys is None or b.keys is None:
        raise TypeError("cosine_similarity expects two map values")
    la, lb = _elem_live(a), _elem_live(b)
    va = torch.where(la, a.data.to(torch.float64), 0.0)
    vb = torch.where(lb, b.data.to(torch.float64), 0.0)
    kad, kbd, _ = _pair_codes(a.keys, b.keys)
    keq = (kad[:, :, None] == kbd[:, None, :]) & la[:, :, None] & lb[:, None, :]
    dot = (keq * va[:, :, None] * vb[:, None, :]).sum(dim=(1, 2))
    denom = torch.sqrt((va * va).sum(dim=1)) * torch.sqrt((vb * vb).sum(dim=1))
    out = torch.where(denom > 0, dot / torch.clamp(denom, min=1e-300), float("nan"))
    return Val(out, and_valid(a.valid, b.valid), T.DOUBLE)


# ---------------------------------------------------------------------------
# quantile-sketch readers (qdigest_agg states, ops/qsketch.py)
# ---------------------------------------------------------------------------


@register("value_at_quantile", _double_infer)
def _value_at_quantile(sk: Val, q: Val, out_type: T.Type) -> Val:
    from ..ops import qsketch as qs

    if sk.data.ndim != 2:
        raise TypeError("value_at_quantile expects a qdigest sketch value")
    frac = float(_require_literal(q, "value_at_quantile fraction"))
    vals = qs.percentile_value(sk.data, frac)
    return Val(vals.to(torch.float64), and_valid(sk.valid, sk.data.sum(dim=1) > 0), T.DOUBLE)


@register("quantile_at_value", _double_infer)
def _quantile_at_value(sk: Val, v: Val, out_type: T.Type) -> Val:
    """Inverse read: the rank (0..1) of `v` in the sketch's distribution —
    the counts of the bins below the value's bin plus half its own."""
    from ..ops import qsketch as qs

    if sk.data.ndim != 2:
        raise TypeError("quantile_at_value expects a qdigest sketch value")
    bucket = qs.bucket_of(v.data.to(torch.float64))
    if bucket.ndim == 0:
        bucket = bucket.expand(sk.data.shape[0])
    total = sk.data.sum(dim=1)
    lane = torch.arange(sk.data.shape[1], device=sk.device)[None, :]
    below = torch.where(lane < bucket[:, None], sk.data, 0).sum(dim=1)
    own = torch.gather(sk.data, 1, bucket[:, None])[:, 0]
    rank = (below + 0.5 * own) / torch.clamp(total, min=1)
    return Val(rank, and_valid(sk.valid, v.valid, total > 0), T.DOUBLE)


# ---------------------------------------------------------------------------
# ML scalars (reference presto-ml regress/classify over learned models,
# ops/mlreg.py's MODEL layout)
# ---------------------------------------------------------------------------


def _model_lanes(model: Val, n: int):
    """(model data, model lengths) broadcast to n rows."""
    from ..ops import mlreg

    mdata = mlreg.logical_values(model.data, model.type)
    mlens = array_lengths(model)
    if mdata.shape[0] == 1 and n > 1:
        mdata = mdata.expand(n, -1)
        mlens = mlens.expand(n)
    return mdata, mlens


@register("regress", _double_infer)
def _regress(features: Val, model: Val, out_type: T.Type) -> Val:
    """regress(features, model): dot(features, weights) + intercept."""
    from ..ops import mlreg

    if not isinstance(features.type, T.ArrayType) or not isinstance(model.type, T.ArrayType):
        raise TypeError("regress takes (features array, model array)")
    fdata = mlreg.logical_values(features.data, features.type)
    mdata, mlens = _model_lanes(model, fdata.shape[0])
    if mdata.shape[1] == mlreg.MODEL_WIDTH:
        # a learned model: the two trailing lanes are label bounds, not
        # weights (a literal of exactly MODEL_WIDTH lanes reads the same)
        mdata = mdata[:, :mlreg.MODEL_WIDTH - 2]
        mlens = torch.clamp(mlens, max=mlreg.MODEL_WIDTH - 2)
    out = mlreg.predict(fdata, array_lengths(features), mdata, mlens)
    return Val(out, and_valid(features.valid, model.valid), T.DOUBLE)


@register("classify", _bigint_infer)
def _classify(features: Val, model: Val, out_type: T.Type) -> Val:
    """classify(features, model): the ridge score rounded and CLAMPED to
    the label range the model recorded at training time (ops/mlreg.py)."""
    from ..ops import mlreg

    v = _regress(features, model, out_type=T.DOUBLE)
    score = v.data
    mdata, _ = _model_lanes(model, score.shape[0])
    if mdata.shape[1] == mlreg.MODEL_WIDTH:
        score = torch.minimum(torch.maximum(score, mdata[:, -2]), mdata[:, -1])
    return Val(torch.round(score).to(torch.int64), v.valid, T.BIGINT)


# ---------------------------------------------------------------------------
# statistical distribution functions (reference MathFunctions.java's
# normal_cdf/beta_cdf/... family): torch.special where it has the function
# (ndtr, ndtri, gammainc, gammaincc); the regularized incomplete beta, which
# torch lacks, as a fixed-count continued fraction here
# ---------------------------------------------------------------------------

BETA_CF_EPS = 1e-15  # relative step of the continued fraction at convergence
BETA_CF_MAX_STEPS = 2000


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b) (Numerical Recipes' betacf,
    modified Lentz): the continued fraction converges fast for
    x < (a + 1) / (a + b + 2); beyond it, the symmetry I_x(a, b) =
    1 - I_{1-x}(b, a). Steps go in batches of 8 until every element's last
    step changed its value by less than BETA_CF_EPS (one host read per
    batch). NaN outside 0 <= x <= 1."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    tiny = 1e-300
    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = torch.ones_like(xx)
    d = 1.0 - qab * xx / qap
    d = 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)
    h = d.clone()
    for m in range(1, BETA_CF_MAX_STEPS + 1):
        m2 = 2.0 * m
        for num in (m * (bb - m) * xx / ((qam + m2) * (aa + m2)),
                    -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))):
            d = 1.0 + num * d
            d = 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)
            c = 1.0 + num / c
            c = torch.where(torch.abs(c) < tiny, tiny, c)
            delta = d * c
            h = h * delta
        if m % 8 == 0 and not bool((torch.abs(delta - 1.0) >= BETA_CF_EPS).any()):
            break
    safe = torch.clamp(xx, 1e-300, 1.0 - 1e-16)
    lfront = (torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
              + aa * torch.log(safe) + bb * torch.log1p(-safe))
    front = torch.exp(lfront) * h / aa
    out = torch.where(swap, 1.0 - front, front)
    out = torch.where(x == 0.0, 0.0, torch.where(x == 1.0, 1.0, out))
    # outside [0, 1] (Presto raises): NaN, as scipy's and jax's betainc
    return torch.where((x < 0.0) | (x > 1.0), float("nan"), out)


def _cdf(name: str, fn):
    """cdf(p1, [p2,] value) family: doubles in, double out, NULL on NULL."""

    @register(name, _double_infer)
    def _impl(*vals, out_type: T.Type, _fn=fn) -> Val:
        return Val(_fn(*(_to_double(v) for v in vals)),
                   and_valid(*(v.valid for v in vals)), T.DOUBLE)

    return _impl


def _laplace(m, b, x):
    z = (x - m) / b
    return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))


def _binomial(n, p, k):
    k = torch.floor(k)
    return betainc(torch.clamp(n - k, min=1e-12), k + 1.0, 1.0 - p)


_cdf("normal_cdf", lambda m, sd, x: torch.special.ndtr((x - m) / sd))
_cdf("inverse_normal_cdf", lambda m, sd, p: m + sd * torch.special.ndtri(p))
_cdf("beta_cdf", betainc)
_cdf("cauchy_cdf", lambda m, g, x: 0.5 + torch.atan((x - m) / g) / math.pi)
_cdf("gamma_cdf", lambda sh, sc, x: torch.special.gammainc(sh, torch.clamp(x / sc, min=0.0)))
_cdf("laplace_cdf", _laplace)
_cdf("weibull_cdf",
     lambda a, b, x: 1.0 - torch.exp(-torch.pow(torch.clamp(x, min=0.0) / b, a)))
_cdf("chi_squared_cdf",
     lambda df, x: torch.special.gammainc(df / 2.0, torch.clamp(x, min=0.0) / 2.0))
_cdf("poisson_cdf", lambda lam, k: torch.where(
    k < 0, 0.0, torch.special.gammaincc(torch.floor(torch.clamp(k, min=0.0)) + 1.0, lam)))
_cdf("binomial_cdf", _binomial)


@register("inverse_beta_cdf", _double_infer)
def _inverse_beta_cdf(a: Val, b: Val, p: Val, out_type: T.Type) -> Val:
    """Inverse of beta_cdf: 8 bisection steps on [0, 1], then Newton steps
    on the beta density kept inside the bisection bracket, until every
    step is below 1e-15 (the JAX package bisects 64 times)."""
    av, bv, target = torch.broadcast_tensors(_to_double(a), _to_double(b), _to_double(p))
    lo = torch.zeros_like(target)
    hi = torch.ones_like(target)
    for _ in range(8):
        mid = 0.5 * (lo + hi)
        go_hi = betainc(av, bv, mid) < target
        lo = torch.where(go_hi, mid, lo)
        hi = torch.where(go_hi, hi, mid)
    x = 0.5 * (lo + hi)
    lbeta = torch.lgamma(av) + torch.lgamma(bv) - torch.lgamma(av + bv)
    for _ in range(60):
        f = betainc(av, bv, x) - target
        lo = torch.where(f < 0, x, lo)
        hi = torch.where(f < 0, hi, x)
        pdf = torch.exp((av - 1.0) * torch.log(x) + (bv - 1.0) * torch.log1p(-x) - lbeta)
        nxt = x - f / pdf
        nxt = torch.where((nxt > lo) & (nxt < hi) & torch.isfinite(nxt), nxt, 0.5 * (lo + hi))
        step = torch.abs(nxt - x)
        x = nxt
        if not bool((step > 1e-15 * torch.clamp(torch.abs(x), min=1e-300)).any()):
            break
    return Val(x, and_valid(a.valid, b.valid, p.valid), T.DOUBLE)


# ---------------------------------------------------------------------------
# geometry (reference presto-geospatial GeoFunctions.java over
# ops/geometry.py): a geometry value is an ARRAY(DOUBLE) of interleaved
# [x0, y0, x1, y1, ...] with lengths = 2 * vertex count, so st_point
# values compose with the polygon functions
# ---------------------------------------------------------------------------


def _broadcast_rows(*xs):
    """Bring 0-d (constant) operands to the row count of the others."""
    n = max((x.shape[0] for x in xs if x.ndim), default=1)
    return [x.expand(n) if x.ndim == 0 else x for x in xs]


@register("st_point", lambda ts: T.ArrayType(T.DOUBLE))
def _st_point(x: Val, y: Val, out_type: T.Type) -> Val:
    xd, yd = _broadcast_rows(_to_double(x), _to_double(y))
    data = torch.stack([xd, yd], dim=1)
    return Val(data, and_valid(x.valid, y.valid), T.ArrayType(T.DOUBLE),
               lengths=torch.full(data.shape[:1], 2, dtype=torch.int32, device=data.device))


def _point_xy(p: Val, what: str):
    if p.lengths is None or p.data.shape[1] < 2:
        raise TypeError(f"{what} requires a POINT (st_point) value")
    return p.data[:, 0], p.data[:, 1]


@register("st_x", _double_infer)
def _st_x(p: Val, out_type: T.Type) -> Val:
    return Val(_point_xy(p, "st_x")[0], p.valid, T.DOUBLE)


@register("st_y", _double_infer)
def _st_y(p: Val, out_type: T.Type) -> Val:
    return Val(_point_xy(p, "st_y")[1], p.valid, T.DOUBLE)


@register("st_distance", _double_infer)
def _st_distance(a: Val, b: Val, out_type: T.Type) -> Val:
    ax, ay = _point_xy(a, "st_distance")
    bx, by = _point_xy(b, "st_distance")
    return Val(torch.sqrt((ax - bx) ** 2 + (ay - by) ** 2), and_valid(a.valid, b.valid),
               T.DOUBLE)


def _geom_verts(g: Val, what: str):
    """Interleaved lanes -> ((n, V, 2) vertices, (n,) counts)."""
    if g.lengths is None or g.data.ndim != 2:
        raise TypeError(f"{what} requires a geometry value")
    d = g.data.to(torch.float64)
    if d.shape[1] % 2:
        d = d[:, :-1]
    return d.reshape(d.shape[0], -1, 2), torch.div(g.lengths, 2, rounding_mode="floor")


def _wkt_parse_val(a: Val, what: str) -> Val:
    from ..ops import geometry as geo

    d = a.dictionary
    if d is None:
        raise TypeError(f"{what} expects a varchar WKT value")
    geoms, oks = [], np.zeros(max(len(d), 1), np.bool_)
    for i, x in enumerate(d):
        try:
            geoms.append(geo.parse_wkt(x)[1])
            oks[i] = True
        except ValueError:
            geoms.append(np.zeros((1, 2), np.float64))
    verts, nv = geo.pack_vertices(geoms or [np.zeros((1, 2), np.float64)])
    codes = torch.clamp(a.data.to(torch.int64), 0, max(len(d) - 1, 0))
    data = to_tensor(verts.reshape(verts.shape[0], -1), torch.float64, a.device)[codes]
    lens = to_tensor(nv * 2, torch.int32, a.device)[codes]
    valid = and_valid(a.valid, to_tensor(oks, torch.bool, a.device)[codes])
    return Val(data, valid, T.ArrayType(T.DOUBLE), lengths=lens)


for _geo_name in ("st_geometryfromtext", "st_polygon", "st_linefromtext"):
    register(_geo_name, lambda ts: T.ArrayType(T.DOUBLE))(
        lambda a, out_type, _n=_geo_name: _wkt_parse_val(a, _n))


def _broadcast_geoms(a: Val, b: Val, what: str):
    va, na = _geom_verts(a, what)
    vb, nb = _geom_verts(b, what)
    n = max(va.shape[0], vb.shape[0])
    if va.shape[0] == 1 and n > 1:
        va, na = va.expand(n, -1, -1), na.expand(n)
    if vb.shape[0] == 1 and n > 1:
        vb, nb = vb.expand(n, -1, -1), nb.expand(n)
    return va, na, vb, nb


@register("st_contains", _bool_infer)
def _st_contains(g: Val, p: Val, out_type: T.Type) -> Val:
    """st_contains(geometry, geometry): every vertex of the right operand
    inside the left ring AND no proper edge crossing (boundary contact
    allowed)."""
    from ..ops import geometry as geo

    va, na, vb, nb = _broadcast_geoms(g, p, "st_contains")
    return Val(geo.contains_all_vertices(va, na, vb, nb), and_valid(g.valid, p.valid),
               T.BOOLEAN)


@register("st_within", _bool_infer)
def _st_within(p: Val, g: Val, out_type: T.Type) -> Val:
    return _st_contains(g, p, out_type=T.BOOLEAN)


@register("st_intersects", _bool_infer)
def _st_intersects(a: Val, b: Val, out_type: T.Type) -> Val:
    from ..ops import geometry as geo

    va, na, vb, nb = _broadcast_geoms(a, b, "st_intersects")
    return Val(geo.polygons_intersect(va, na, vb, nb), and_valid(a.valid, b.valid), T.BOOLEAN)


@register("st_disjoint", _bool_infer)
def _st_disjoint(a: Val, b: Val, out_type: T.Type) -> Val:
    v = _st_intersects(a, b, out_type=T.BOOLEAN)
    return Val(~v.data, v.valid, T.BOOLEAN)


def _geom_measure(name: str, fn_name: str):
    @register(name, _double_infer)
    def _impl(g: Val, out_type: T.Type) -> Val:
        from ..ops import geometry as geo

        v, nv = _geom_verts(g, name)
        return Val(getattr(geo, fn_name)(v, nv), g.valid, T.DOUBLE)

    return _impl


_geom_measure("st_area", "polygon_area")
_geom_measure("st_length", "line_length")
_geom_measure("st_perimeter", "ring_perimeter")


@register("st_centroid", lambda ts: T.ArrayType(T.DOUBLE))
def _st_centroid(g: Val, out_type: T.Type) -> Val:
    from ..ops import geometry as geo

    v, nv = _geom_verts(g, "st_centroid")
    data = torch.stack(geo.polygon_centroid(v, nv), dim=1)
    return Val(data, g.valid, T.ArrayType(T.DOUBLE),
               lengths=torch.full(data.shape[:1], 2, dtype=torch.int32, device=data.device))


def _geom_reduce(g: Val, what: str, axis_sel: int, kind: str) -> Val:
    v, nv = _geom_verts(g, what)
    lanes = torch.arange(v.shape[1], device=v.device)[None, :] < nv[:, None]
    coord = v[..., axis_sel]
    if kind == "min":
        out = torch.where(lanes, coord, float("inf")).amin(dim=1)
    else:
        out = torch.where(lanes, coord, float("-inf")).amax(dim=1)
    return Val(out, and_valid(g.valid, nv > 0), T.DOUBLE)


for _nm, _ax, _kind in (("st_xmin", 0, "min"), ("st_xmax", 0, "max"),
                        ("st_ymin", 1, "min"), ("st_ymax", 1, "max")):
    register(_nm, _double_infer)(
        lambda g, out_type, _n=_nm, _a=_ax, _k=_kind: _geom_reduce(g, _n, _a, _k))


@register("st_envelope", lambda ts: T.ArrayType(T.DOUBLE))
def _st_envelope(g: Val, out_type: T.Type) -> Val:
    """Bounding-box polygon (closed 5-vertex ring)."""
    x0 = _geom_reduce(g, "st_envelope", 0, "min").data
    x1 = _geom_reduce(g, "st_envelope", 0, "max").data
    y0 = _geom_reduce(g, "st_envelope", 1, "min").data
    y1 = _geom_reduce(g, "st_envelope", 1, "max").data
    data = torch.stack([x0, y0, x1, y0, x1, y1, x0, y1, x0, y0], dim=1)
    return Val(data, g.valid, T.ArrayType(T.DOUBLE),
               lengths=torch.full(data.shape[:1], 10, dtype=torch.int32, device=data.device))


@register("st_isclosed", _bool_infer)
def _st_isclosed(g: Val, out_type: T.Type) -> Val:
    v, nv = _geom_verts(g, "st_isclosed")
    li = torch.clamp(nv - 1, min=0).to(torch.int64)
    last = torch.gather(v, 1, li[:, None, None].expand(-1, 1, 2))[:, 0]
    return Val((v[:, 0] == last).all(dim=1) & (nv >= 3), g.valid, T.BOOLEAN)


@register("st_isempty", _bool_infer)
def _st_isempty(g: Val, out_type: T.Type) -> Val:
    return Val(_geom_verts(g, "st_isempty")[1] == 0, g.valid, T.BOOLEAN)


@register("st_numpoints", _bigint_infer)
def _st_numpoints(g: Val, out_type: T.Type) -> Val:
    return Val(_geom_verts(g, "st_numpoints")[1].to(torch.int64), g.valid, T.BIGINT)
