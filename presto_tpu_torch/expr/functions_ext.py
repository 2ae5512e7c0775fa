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

Not ported yet (they raise "not ported yet", see functions.NOT_PORTED): the
array, map and geometry functions, the statistical `*_cdf` family, and the
array forms of `reverse` and `concat`.

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
from .functions import (
    _STRFTIME_SPECS,
    _TS_US,
    FUNCTIONS,
    NotPortedError,
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
    intern_dictionary,
    register,
    shift_right_logical,
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
    """repeat(element, n) as an array value inside an expression (element_at
    reads it); arrays as results wait for collections."""
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

