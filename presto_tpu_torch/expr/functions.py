"""Scalar function registry (torch counterpart of presto_tpu/expr/functions.py).

Re-designed equivalent of the reference's FunctionRegistry
(presto-main/.../metadata/FunctionRegistry.java:360) plus the scalar
implementations under presto-main/.../operator/scalar/. Each function
declares a type-inference rule and an eager implementation over `Val`
(data tensor + validity mask + type + dictionary id).

Varchar strategy: functions/predicates over strings are evaluated once per
*dictionary entry* on the host, then applied to the code tensor with one
device gather — O(|dict|) host work + O(rows) gather.

Null semantics: scalar functions are null-propagating (RETURNS NULL ON NULL
INPUT, the reference default); special forms in compiler.py implement Kleene
AND/OR, IS NULL, COALESCE, IF/CASE.

Every function of the JAX package's registry is ported. Array and map
values are (capacity, width) data with per-row `lengths`, an optional
element null mask and, for a MAP, the keys in a companion array (`keys`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..page import dictionary_by_id, intern_dictionary, to_tensor
from . import datetime_kernels as dt


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this package does not have yet."""


@dataclasses.dataclass
class Val:
    """A vectorized SQL value during expression evaluation.

    `literal` holds the Python value when this Val came from a constant —
    functions with literal-only arguments (LIKE patterns, substr positions)
    read it instead of device data."""

    data: torch.Tensor
    valid: Optional[torch.Tensor]  # None = no nulls
    type: T.Type
    dict_id: Optional[int] = None
    literal: object = None
    # array/map values only: per-row element counts, the per-element null
    # mask, and a MAP's keys (an array value of the same width)
    lengths: Optional[torch.Tensor] = None
    elem_valid: Optional[torch.Tensor] = None
    keys: Optional["Val"] = None

    @property
    def dictionary(self) -> Optional[Tuple[str, ...]]:
        return None if self.dict_id is None else dictionary_by_id(self.dict_id)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_mask(self):
        # validity is per ROW: long-decimal data is (n, 2) lanes but the
        # mask stays (n,)
        if self.valid is None:
            return torch.ones(self.data.shape[:1], dtype=torch.bool, device=self.device)
        return self.valid


def and_valid(*valids):
    """Combine validity masks; None means all-valid."""
    out = None
    for v in valids:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _table(values, dtype, like: torch.Tensor) -> torch.Tensor:
    """A host-built lookup table on the device of `like`."""
    return to_tensor(np.asarray(values), dtype, like.device)


def _gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return table[codes.to(torch.int64)]


# ---------------------------------------------------------------------------
# registry plumbing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScalarFunction:
    name: str
    infer: Callable[[Tuple[T.Type, ...]], T.Type]
    impl: Callable[..., Val]  # (*vals, out_type=Type) -> Val


FUNCTIONS: dict = {}


def register(name, infer):
    def deco(fn):
        FUNCTIONS[name] = ScalarFunction(name, infer, fn)
        return fn

    return deco


def infer_call_type(name: str, arg_types: Tuple[T.Type, ...]) -> T.Type:
    f = FUNCTIONS.get(name)
    if f is None:
        raise KeyError(f"unknown function {name!r}")
    return f.infer(arg_types)


def apply_function(name: str, vals: Sequence[Val], out_type: T.Type) -> Val:
    f = FUNCTIONS.get(name)
    if f is None:
        raise KeyError(f"unknown function {name!r}")
    return f.impl(*vals, out_type=out_type)


# ---------------------------------------------------------------------------
# type rules
# ---------------------------------------------------------------------------


def _arith_infer(op):
    def infer(ts: Tuple[T.Type, ...]) -> T.Type:
        a, b = ts
        if isinstance(a, T.DateType) or isinstance(b, T.DateType):
            if op in ("add", "subtract"):
                if isinstance(a, T.DateType) and isinstance(b, T.DateType):
                    return T.BIGINT  # date difference in days
                return T.DATE
        if isinstance(a, T.TimestampType) or isinstance(b, T.TimestampType):
            if op in ("add", "subtract") and any(
                isinstance(x, (T.IntervalDayType, T.IntervalYearMonthType))
                for x in (a, b)
            ):
                return T.TIMESTAMP
        da, db = isinstance(a, T.DecimalType), isinstance(b, T.DecimalType)
        if T.is_floating(a) or T.is_floating(b):
            return T.DOUBLE
        if da or db:
            sa = a.scale if da else 0
            sb = b.scale if db else 0
            long = (da and a.precision > 18) or (db and b.precision > 18)
            p = 38 if long else 18
            if op in ("add", "subtract"):
                return T.DecimalType(p, max(sa, sb))
            if op == "multiply":
                return T.DecimalType(p, min(sa + sb, 18))
            if op == "divide":
                return T.DecimalType(p, max(sa, sb, 6))
            if op == "modulus":
                return T.DecimalType(p, max(sa, sb))
        return T.common_super_type(a, b)

    return infer


def _bool_infer(ts):
    return T.BOOLEAN


def _same_as_first(ts):
    return ts[0]


def _double_infer(ts):
    return T.DOUBLE


def _bigint_infer(ts):
    return T.BIGINT


def _varchar_infer(ts):
    return T.VARCHAR


# ---------------------------------------------------------------------------
# numeric helpers
# ---------------------------------------------------------------------------


def _scale_of(t: T.Type) -> int:
    return t.scale if isinstance(t, T.DecimalType) else 0


def _div_round(x, y):
    """Round-half-up signed integer division (SQL decimal semantics,
    reference Decimals.java HALF_UP rescale)."""
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    sign = torch.sign(x) * torch.sign(y)
    q = (2 * torch.abs(x) + torch.abs(y)) // (2 * torch.abs(y))
    return sign * q


def _rescale(data, from_scale: int, to_scale: int):
    """Rescale a scaled-int decimal; scale-down rounds half-up."""
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    return _div_round(data, 10 ** (from_scale - to_scale))


def _round_half_away(x):
    """SQL ROUND for floats: half away from zero (not banker's rounding)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _to_double(v: Val):
    s = _scale_of(v.type)
    if v.data.ndim == 2:  # long-decimal lanes
        from ..ops import decimal128 as d128

        d = d128.to_float64(v.data)
    else:
        d = v.data.to(torch.float64)
    return d / (10**s) if s else d


def _numeric_align(a: Val, b: Val, out_type: T.Type):
    """Bring both operands into the output type's representation.
    Long-decimal outputs align as lane pairs."""
    if isinstance(out_type, (T.DoubleType, T.RealType)):
        return _to_double(a), _to_double(b)
    if isinstance(out_type, T.DecimalType):
        if out_type.is_long:
            return _to_lanes(a, out_type.scale), _to_lanes(b, out_type.scale)
        return (
            _rescale(a.data.to(torch.int64), _scale_of(a.type), out_type.scale),
            _rescale(b.data.to(torch.int64), _scale_of(b.type), out_type.scale),
        )
    dtype = out_type.storage_dtype
    return a.data.to(dtype), b.data.to(dtype)


def _is_long_dec(t: T.Type) -> bool:
    return isinstance(t, T.DecimalType) and t.precision > 18


def _to_lanes(v: Val, to_scale: int):
    """Any numeric Val -> two-lane representation at `to_scale`."""
    from ..ops import decimal128 as d128

    s = _scale_of(v.type)
    n = v.data.shape[0]
    data = v.data
    if v.literal is not None and v.valid is None and n > 1:
        data = data[:1]  # a constant: convert one row, then broadcast it
    lanes = data if data.ndim == 2 else d128.from_int64(data.to(torch.int64))
    lanes = d128.rescale(lanes, to_scale - s)
    return lanes.expand(n, 2) if lanes.shape[0] != n else lanes


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

_TS_US = 1_000_000


def _ts_interval_shift(ts_data, delta: Val, sign: int):
    day_us = 86400 * _TS_US
    if isinstance(delta.type, T.IntervalYearMonthType):
        days = ts_data // day_us
        rem = ts_data - days * day_us
        return dt.add_months(days, sign * delta.data).to(torch.int64) * day_us + rem
    return ts_data + sign * delta.data.to(torch.int64) * day_us


@register("add", _arith_infer("add"))
def _add(a: Val, b: Val, out_type: T.Type) -> Val:
    valid = and_valid(a.valid, b.valid)
    if isinstance(out_type, T.TimestampType) and any(
        isinstance(x.type, (T.IntervalDayType, T.IntervalYearMonthType))
        for x in (a, b)
    ):
        ts, delta = (a, b) if isinstance(a.type, T.TimestampType) else (b, a)
        return Val(_ts_interval_shift(ts.data, delta, 1), valid, T.TIMESTAMP)
    if isinstance(out_type, T.DateType):
        date, delta = (a, b) if isinstance(a.type, T.DateType) else (b, a)
        if isinstance(delta.type, T.IntervalYearMonthType):
            data = dt.add_months(date.data, delta.data)
        else:
            data = (date.data.to(torch.int64) + delta.data).to(torch.int32)
        return Val(data, valid, T.DATE)
    x, y = _numeric_align(a, b, out_type)
    if _is_long_dec(out_type):
        from ..ops import decimal128 as d128

        return Val(d128.dadd(x, y), valid, out_type)
    return Val(x + y, valid, out_type)


@register("subtract", _arith_infer("subtract"))
def _subtract(a: Val, b: Val, out_type: T.Type) -> Val:
    valid = and_valid(a.valid, b.valid)
    if isinstance(out_type, T.TimestampType) and isinstance(
        b.type, (T.IntervalDayType, T.IntervalYearMonthType)
    ):
        return Val(_ts_interval_shift(a.data, b, -1), valid, T.TIMESTAMP)
    if isinstance(out_type, T.DateType):
        if isinstance(b.type, T.IntervalYearMonthType):
            data = dt.add_months(a.data, -b.data)
        else:
            data = (a.data.to(torch.int64) - b.data).to(torch.int32)
        return Val(data, valid, T.DATE)
    if isinstance(a.type, T.DateType) and isinstance(b.type, T.DateType):
        return Val(a.data.to(torch.int64) - b.data.to(torch.int64), valid, T.BIGINT)
    x, y = _numeric_align(a, b, out_type)
    if _is_long_dec(out_type):
        from ..ops import decimal128 as d128

        return Val(d128.dsub(x, y), valid, out_type)
    return Val(x - y, valid, out_type)


@register("multiply", _arith_infer("multiply"))
def _multiply(a: Val, b: Val, out_type: T.Type) -> Val:
    valid = and_valid(a.valid, b.valid)
    if isinstance(out_type, T.DecimalType):
        have = _scale_of(a.type) + _scale_of(b.type)
        if out_type.is_long:
            from ..ops import decimal128 as d128

            wide, narrow = (a, b) if a.data.ndim == 2 else (b, a)
            if wide.data.ndim != 2:  # both short but long result type
                lanes = d128.dmul_int64(
                    d128.from_int64(a.data.to(torch.int64)), b.data.to(torch.int64)
                )
            else:
                if narrow.data.ndim == 2:
                    raise NotImplementedError(
                        "multiply of two long decimals is not supported"
                    )
                lanes = d128.dmul_int64(wide.data, narrow.data.to(torch.int64))
            return Val(d128.rescale(lanes, out_type.scale - have), valid, out_type)
        raw = a.data.to(torch.int64) * b.data.to(torch.int64)
        return Val(_rescale(raw, have, out_type.scale), valid, out_type)
    x, y = _numeric_align(a, b, out_type)
    return Val(x * y, valid, out_type)


@register("divide", _arith_infer("divide"))
def _divide(a: Val, b: Val, out_type: T.Type) -> Val:
    valid = and_valid(a.valid, b.valid)
    if isinstance(out_type, T.DecimalType):
        xs, ys = _scale_of(a.type), _scale_of(b.type)
        if out_type.is_long:
            from ..ops import decimal128 as d128

            x = _to_lanes(a, out_type.scale + ys)
            if b.data.ndim == 2:
                y = d128.to_int64(b.data)
            else:
                y = b.data.to(torch.int64)
            q = d128.ddiv_wide(x, y)
            valid = and_valid(valid, y != 0)
            return Val(d128.from_int64(q), valid, out_type)
        x_src = a.data
        if x_src.ndim == 2:
            from ..ops import decimal128 as d128

            x_src = d128.to_int64(x_src)
        x = _rescale(x_src.to(torch.int64), xs, out_type.scale + ys)
        y = b.data.to(torch.int64)
        safe = torch.where(y == 0, 1, y)
        q = _div_round(x, safe)
        valid = and_valid(valid, b.data != 0)
        return Val(q, valid, out_type)
    x, y = _numeric_align(a, b, out_type)
    if not x.is_floating_point():
        safe = torch.where(y == 0, 1, y)
        q = torch.sign(x) * torch.sign(safe) * (torch.abs(x) // torch.abs(safe))
        return Val(q, and_valid(valid, y != 0), out_type)
    return Val(x / y, valid, out_type)


@register("modulus", _arith_infer("modulus"))
def _modulus(a: Val, b: Val, out_type: T.Type) -> Val:
    valid = and_valid(a.valid, b.valid)
    x, y = _numeric_align(a, b, out_type)
    if not x.is_floating_point():
        safe = torch.where(y == 0, 1, y)
        # truncated division remainder (sign follows dividend, SQL semantics)
        r = x - (torch.sign(x) * torch.sign(safe) * (torch.abs(x) // torch.abs(safe))) * safe
        return Val(r, and_valid(valid, y != 0), out_type)
    return Val(x - torch.trunc(x / y) * y, valid, out_type)


@register("mod", _arith_infer("modulus"))
def _mod(a: Val, b: Val, out_type: T.Type) -> Val:
    return _modulus(a, b, out_type=out_type)


@register("negate", _same_as_first)
def _negate(a: Val, out_type: T.Type) -> Val:
    if a.data.ndim == 2:
        from ..ops import decimal128 as d128

        return Val(d128.dneg(a.data), a.valid, out_type)
    return Val(-a.data, a.valid, out_type)


# ---------------------------------------------------------------------------
# comparisons (null-propagating; varchar via dictionary codes)
# ---------------------------------------------------------------------------


def require_sorted_dict(v: Val, what: str):
    d = v.dictionary
    if d is not None and not getattr(d, "is_sorted", True):
        raise NotImplementedError(
            f"{what} on a column with an unsorted dictionary "
            f"({type(d).__name__}); codes do not order like strings"
        )


def _bisect(d, s: str, side: str) -> int:
    """Binary search over any (possibly lazy) sorted dictionary."""
    lo, hi = 0, len(d)
    while lo < hi:
        mid = (lo + hi) // 2
        e = d[mid]
        if e < s or (side == "right" and e == s):
            lo = mid + 1
        else:
            hi = mid
    return lo


_LITERAL_CMP = {
    "eq": lambda codes, bl, br: (codes >= bl) & (codes < br),
    "ne": lambda codes, bl, br: (codes < bl) | (codes >= br),
    "lt": lambda codes, bl, br: codes < bl,
    "le": lambda codes, bl, br: codes < br,
    "gt": lambda codes, bl, br: codes >= br,
    "ge": lambda codes, bl, br: codes >= bl,
}


def _literal_cmp_fastpath(name: str, a: Val, b: Val):
    """column <op> 'literal' without unifying dictionaries: bisect the
    literal's position in the sorted column dictionary and compare codes."""
    col_v, lit_v, flip = (a, b, False) if len(b.dictionary or ()) == 1 else (b, a, True)
    d = col_v.dictionary
    if d is None:
        return None
    require_sorted_dict(col_v, f"comparison {name!r}")
    s = lit_v.dictionary[0]
    bl = _bisect(d, s, "left")
    br = _bisect(d, s, "right")
    if flip:
        name = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(name, name)
    return _LITERAL_CMP[name](col_v.data, bl, br)


def _compare_long(name: str, a: Val, b: Val):
    from ..ops import decimal128 as d128

    s = max(_scale_of(a.type), _scale_of(b.type))
    x, y = _to_lanes(a, s), _to_lanes(b, s)
    if name == "eq":
        return d128.dcmp_eq(x, y)
    if name == "ne":
        return ~d128.dcmp_eq(x, y)
    if name == "lt":
        return d128.dcmp_lt(x, y)
    if name == "gt":
        return d128.dcmp_lt(y, x)
    if name == "le":
        return ~d128.dcmp_lt(y, x)
    if name == "ge":
        return ~d128.dcmp_lt(x, y)
    raise KeyError(name)


def _compare(op, a: Val, b: Val, name: str = ""):
    if _is_long_dec(a.type) or _is_long_dec(b.type):
        if T.is_floating(a.type) or T.is_floating(b.type):
            return op(_to_double(a), _to_double(b))
        return _compare_long(name, a, b)
    if isinstance(a.type, T.VarcharType) and isinstance(b.type, T.VarcharType):
        if name in _LITERAL_CMP and (
            len(a.dictionary or ()) == 1 or len(b.dictionary or ()) == 1
        ):
            fast = _literal_cmp_fastpath(name, a, b)
            if fast is not None:
                return fast
        if name in ("lt", "le", "gt", "ge"):
            require_sorted_dict(a, f"comparison {name!r}")
            require_sorted_dict(b, f"comparison {name!r}")
        xa, xb, _ = unify_dictionaries(a, b)
        return op(xa, xb)
    if T.is_floating(a.type) or T.is_floating(b.type):
        return op(_to_double(a), _to_double(b))
    sa, sb = _scale_of(a.type), _scale_of(b.type)
    s = max(sa, sb)
    return op(
        _rescale(a.data.to(torch.int64) if sa != s else a.data, sa, s),
        _rescale(b.data.to(torch.int64) if sb != s else b.data, sb, s),
    )


_UNIFY_MATERIALIZE_LIMIT = 1_000_000


def unify_dictionaries(a: Val, b: Val):
    """Remap two dictionary-coded columns onto one merged sorted
    dictionary: (codes_a, codes_b, merged interned dictionary id)."""
    if a.dict_id is not None and a.dict_id == b.dict_id:
        return a.data, b.data, a.dict_id
    da = a.dictionary or ()
    db = b.dictionary or ()
    if len(da) + len(db) > _UNIFY_MATERIALIZE_LIMIT:
        raise NotImplementedError(
            f"dictionary unification would materialize {len(da)}+{len(db)} "
            "entries; use a literal fast path or dictionary-preserving plan"
        )
    merged = tuple(sorted(set(da) | set(db)))
    index = {s: i for i, s in enumerate(merged)}
    xa = _gather(_table([index[s] for s in da], torch.int32, a.data), a.data) if len(da) else a.data
    xb = _gather(_table([index[s] for s in db], torch.int32, b.data), b.data) if len(db) else b.data
    return xa, xb, intern_dictionary(merged)


def _cmp_factory(name, op):
    @register(name, _bool_infer)
    def _cmp(a: Val, b: Val, out_type: T.Type) -> Val:
        return Val(_compare(op, a, b, name), and_valid(a.valid, b.valid), T.BOOLEAN)

    return _cmp


_cmp_factory("eq", lambda x, y: x == y)
_cmp_factory("ne", lambda x, y: x != y)
_cmp_factory("lt", lambda x, y: x < y)
_cmp_factory("le", lambda x, y: x <= y)
_cmp_factory("gt", lambda x, y: x > y)
_cmp_factory("ge", lambda x, y: x >= y)


# ---------------------------------------------------------------------------
# math scalars
# ---------------------------------------------------------------------------


@register("abs", _same_as_first)
def _abs(a: Val, out_type: T.Type) -> Val:
    if a.data.ndim == 2:
        from ..ops import decimal128 as d128

        return Val(d128.dabs(a.data), a.valid, out_type)
    return Val(torch.abs(a.data), a.valid, out_type)


@register("sqrt", _double_infer)
def _sqrt(a: Val, out_type: T.Type) -> Val:
    x = _to_double(a)
    return Val(torch.sqrt(torch.clamp(x, min=0.0)), and_valid(a.valid, x >= 0), T.DOUBLE)


@register("ln", _double_infer)
def _ln(a: Val, out_type: T.Type) -> Val:
    x = _to_double(a)
    return Val(torch.log(torch.clamp(x, min=1e-300)), and_valid(a.valid, x > 0), T.DOUBLE)


@register("exp", _double_infer)
def _exp(a: Val, out_type: T.Type) -> Val:
    return Val(torch.exp(_to_double(a)), a.valid, T.DOUBLE)


@register("power", _double_infer)
def _power(a: Val, b: Val, out_type: T.Type) -> Val:
    return Val(torch.pow(_to_double(a), _to_double(b)), and_valid(a.valid, b.valid), T.DOUBLE)


@register("floor", _same_as_first)
def _floor(a: Val, out_type: T.Type) -> Val:
    if T.is_floating(a.type):
        return Val(torch.floor(a.data), a.valid, out_type)
    if isinstance(a.type, T.DecimalType):
        s = 10 ** a.type.scale
        d = torch.where(a.data >= 0, a.data // s, -((-a.data + s - 1) // s)) * s
        return Val(d, a.valid, out_type)
    return Val(a.data, a.valid, out_type)


@register("ceil", _same_as_first)
def _ceil(a: Val, out_type: T.Type) -> Val:
    if T.is_floating(a.type):
        return Val(torch.ceil(a.data), a.valid, out_type)
    if isinstance(a.type, T.DecimalType):
        s = 10 ** a.type.scale
        d = torch.where(a.data >= 0, (a.data + s - 1) // s, -((-a.data) // s)) * s
        return Val(d, a.valid, out_type)
    return Val(a.data, a.valid, out_type)


def _round_infer(ts):
    a = ts[0]
    if isinstance(a, T.DecimalType):
        return a
    if T.is_floating(a):
        return T.DOUBLE
    return a


def _require_literal(v: Val, what: str):
    if v.literal is None:
        raise NotImplementedError(f"{what} requires a literal argument")
    return v.literal


@register("round", _round_infer)
def _round(a: Val, *rest, out_type: T.Type) -> Val:
    ndigits = 0
    if rest:
        (nd,) = rest
        ndigits = int(_require_literal(nd, "round precision"))
    if T.is_floating(a.type):
        f = 10.0**ndigits
        return Val(_round_half_away(a.data * f) / f, a.valid, T.DOUBLE)
    if isinstance(a.type, T.DecimalType):
        drop = a.type.scale - ndigits
        if drop <= 0:
            return Val(a.data, a.valid, a.type)
        s = 10**drop
        return Val(_div_round(a.data, s) * s, a.valid, a.type)
    return Val(a.data, a.valid, a.type)


@register("sign", _same_as_first)
def _sign(a: Val, out_type: T.Type) -> Val:
    if a.data.ndim == 2:
        from ..ops import decimal128 as d128

        sg = d128.dsign(a.data)
        return Val(d128.from_int64(sg * 10**out_type.scale), a.valid, out_type)
    if isinstance(out_type, T.DecimalType):
        data = torch.sign(a.data) * (10**out_type.scale)
        return Val(data.to(torch.int64), a.valid, out_type)
    return Val(torch.sign(a.data), a.valid, out_type)


def _unary_double(name, fn, domain=None):
    @register(name, _double_infer)
    def _f(a: Val, out_type: T.Type) -> Val:
        x = _to_double(a)
        valid = a.valid
        if domain is not None:
            valid = and_valid(valid, domain(x))
        return Val(fn(x), valid, T.DOUBLE)

    return _f


_unary_double("log10", torch.log10, domain=lambda x: x > 0)
_unary_double("log2", torch.log2, domain=lambda x: x > 0)
_unary_double("degrees", torch.rad2deg)
_unary_double("radians", torch.deg2rad)
_unary_double("sin", torch.sin)
_unary_double("cos", torch.cos)
_unary_double("tan", torch.tan)
_unary_double("asin", torch.asin, domain=lambda x: torch.abs(x) <= 1)
_unary_double("acos", torch.acos, domain=lambda x: torch.abs(x) <= 1)
_unary_double("atan", torch.atan)
_unary_double("sinh", torch.sinh)
_unary_double("cosh", torch.cosh)
_unary_double("tanh", torch.tanh)


@register("is_nan", _bool_infer)
def _is_nan(a: Val, out_type: T.Type) -> Val:
    return Val(torch.isnan(_to_double(a)), a.valid, T.BOOLEAN)


@register("is_finite", _bool_infer)
def _is_finite(a: Val, out_type: T.Type) -> Val:
    return Val(torch.isfinite(_to_double(a)), a.valid, T.BOOLEAN)


@register("is_infinite", _bool_infer)
def _is_infinite(a: Val, out_type: T.Type) -> Val:
    return Val(torch.isinf(_to_double(a)), a.valid, T.BOOLEAN)


# ---------------------------------------------------------------------------
# date/time
# ---------------------------------------------------------------------------


@register("year", _bigint_infer)
def _year(a: Val, out_type: T.Type) -> Val:
    return Val(dt.extract_year(a.data), a.valid, T.BIGINT)


@register("month", _bigint_infer)
def _month(a: Val, out_type: T.Type) -> Val:
    return Val(dt.extract_month(a.data), a.valid, T.BIGINT)


@register("day", _bigint_infer)
def _day(a: Val, out_type: T.Type) -> Val:
    return Val(dt.extract_day(a.data), a.valid, T.BIGINT)


@register("quarter", _bigint_infer)
def _quarter(a: Val, out_type: T.Type) -> Val:
    return Val(dt.extract_quarter(a.data), a.valid, T.BIGINT)


@register("day_of_week", _bigint_infer)
def _day_of_week(a: Val, out_type: T.Type) -> Val:
    # ISO: Monday=1..Sunday=7; 1970-01-01 was a Thursday (=4)
    return Val((a.data.to(torch.int64) + 3) % 7 + 1, a.valid, T.BIGINT)


@register("day_of_year", _bigint_infer)
def _day_of_year(a: Val, out_type: T.Type) -> Val:
    days = a.data.to(torch.int64)
    y, _, _ = dt.days_to_civil(days)
    jan1 = dt.civil_to_days(y, torch.ones_like(y), torch.ones_like(y))
    return Val(days - jan1 + 1, a.valid, T.BIGINT)


def _alias(new: str, existing: str):
    f = FUNCTIONS[existing]
    FUNCTIONS[new] = ScalarFunction(new, f.infer, f.impl)


_alias("dow", "day_of_week")
_alias("doy", "day_of_year")
_alias("day_of_month", "day")


# ---------------------------------------------------------------------------
# varchar functions (host dictionary transforms + device gather)
# ---------------------------------------------------------------------------


def _dict_transform(a: Val, fn: Callable[[str], str], out_type=T.VARCHAR) -> Val:
    """Apply a host string function entry-wise to the dictionary; produce a
    re-sorted dictionary and remap codes with one gather."""
    d = a.dictionary
    if d is None:
        raise TypeError("varchar value lost its dictionary")
    transformed = [fn(s) for s in d]
    new_dict = tuple(sorted(set(transformed)))
    index = {s: i for i, s in enumerate(new_dict)}
    mapping = _table([index[t] for t in transformed], torch.int32, a.data)
    return Val(_gather(mapping, a.data), a.valid, out_type, intern_dictionary(new_dict))


def _dict_predicate(a: Val, pred: Callable[[str], bool]) -> Val:
    d = a.dictionary
    if d is None:
        raise TypeError("varchar value lost its dictionary")
    table = _table([bool(pred(s)) for s in d], torch.bool, a.data)
    return Val(_gather(table, a.data), a.valid, T.BOOLEAN)


@register("lower", _varchar_infer)
def _lower(a: Val, out_type: T.Type) -> Val:
    return _dict_transform(a, str.lower)


@register("upper", _varchar_infer)
def _upper(a: Val, out_type: T.Type) -> Val:
    return _dict_transform(a, str.upper)


@register("length", _bigint_infer)
def _length(a: Val, out_type: T.Type) -> Val:
    table = _table([len(s) for s in a.dictionary or ()], torch.int64, a.data)
    return Val(_gather(table, a.data), a.valid, T.BIGINT)


@register("substr", _varchar_infer)
def _substr(a: Val, start: Val, *rest, out_type: T.Type) -> Val:
    s0 = int(_require_literal(start, "substr start"))
    ln = int(_require_literal(rest[0], "substr length")) if rest else None

    def f(s: str) -> str:
        i = s0 - 1 if s0 > 0 else len(s) + s0
        return s[i : i + ln] if ln is not None else s[i:]

    return _dict_transform(a, f)


@register("trim", _varchar_infer)
def _trim(a: Val, out_type: T.Type) -> Val:
    return _dict_transform(a, str.strip)


@register("concat", _varchar_infer)
def _concat(*vals, out_type: T.Type) -> Val:
    a, b = vals
    da, db = a.dictionary or (), b.dictionary or ()
    if len(da) * len(db) > 1_000_000:
        raise NotImplementedError("concat of two large-dictionary columns")
    merged = tuple(sorted({x + y for x in da for y in db}))
    index = {s: i for i, s in enumerate(merged)}
    table = np.empty((len(da), len(db)), np.int32)
    for i, x in enumerate(da):
        for j, y in enumerate(db):
            table[i, j] = index[x + y]
    t = to_tensor(table, torch.int32, a.device)
    data = t[a.data.to(torch.int64), b.data.to(torch.int64)]
    return Val(data, and_valid(a.valid, b.valid), T.VARCHAR, intern_dictionary(merged))


def like_pattern_to_regex(pattern: str, escape: Optional[str] = None) -> "re.Pattern":
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out), re.DOTALL)


@register("like", _bool_infer)
def _like(a: Val, pattern: Val, *rest, out_type: T.Type) -> Val:
    pat = _require_literal(pattern, "LIKE pattern")
    esc = _require_literal(rest[0], "LIKE escape") if rest else None
    rx = like_pattern_to_regex(pat, esc)
    return _dict_predicate(a, lambda s: rx.fullmatch(s) is not None)


@register("strpos", _bigint_infer)
def _strpos(a: Val, needle: Val, out_type: T.Type) -> Val:
    n = _require_literal(needle, "strpos needle")
    table = _table([s.find(n) + 1 for s in a.dictionary or ()], torch.int64, a.data)
    return Val(_gather(table, a.data), a.valid, T.BIGINT)


@register("starts_with", _bool_infer)
def _starts_with(a: Val, prefix: Val, out_type: T.Type) -> Val:
    p = _require_literal(prefix, "starts_with prefix")
    return _dict_predicate(a, lambda s: s.startswith(p))


@register("ends_with", _bool_infer)
def _ends_with(a: Val, suffix: Val, out_type: T.Type) -> Val:
    p = _require_literal(suffix, "ends_with suffix")
    return _dict_predicate(a, lambda s: s.endswith(p))


def _map_infer_element(ts):
    if isinstance(ts[0], T.MapType):
        return ts[0].value
    return ts[0].element


@register("element_at", _map_infer_element)
def _element_at(a: Val, idx: Val, out_type: T.Type) -> Val:
    """1-based access into an array; negative indexes count from the end;
    out of range -> NULL (element_at's forgiving semantics; the subscript
    routes here too). For a MAP, key lookup -> value or NULL."""
    if isinstance(a.type, T.MapType):
        return _map_element_at(a, idx, out_type)
    if a.lengths is None and a.data.ndim != 2:
        raise TypeError("element_at requires an array value")
    i64 = idx.data.to(torch.int64)
    if a.lengths is None:
        # a fixed-width array with no per-row lengths: every lane is live
        lens = torch.full(a.data.shape[:1], a.data.shape[1], dtype=torch.int64,
                          device=a.device)
    else:
        lens = a.lengths.to(torch.int64)
    pos = torch.where(i64 < 0, lens + i64, i64 - 1)
    in_range = (pos >= 0) & (pos < lens)
    safe = torch.clamp(pos, 0, max(a.data.shape[1] - 1, 0))
    data = torch.gather(a.data, 1, safe[:, None])[:, 0]
    valid = and_valid(a.valid, idx.valid, in_range)
    if a.elem_valid is not None:
        ev = torch.gather(a.elem_valid, 1, safe[:, None])[:, 0]
        valid = and_valid(valid, ev)
    return Val(data, valid, out_type, a.dict_id)


# ---------------------------------------------------------------------------
# math scalars, batch 2 (reference operator/scalar/MathFunctions.java)
# ---------------------------------------------------------------------------


def _cbrt(x):
    """Real cube root: pow(|x|, 1/3) with the sign, then one Newton step
    (torch has no cbrt)."""
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    fine = torch.isfinite(y) & (y != 0)
    safe = torch.where(fine, y, 1.0)
    return torch.where(fine, safe - (safe * safe * safe - x) / (3.0 * safe * safe), y)


_unary_double("cbrt", _cbrt)


@register("atan2", _double_infer)
def _atan2(a: Val, b: Val, out_type: T.Type) -> Val:
    return Val(torch.atan2(_to_double(a), _to_double(b)), and_valid(a.valid, b.valid), T.DOUBLE)


@register("log", _double_infer)
def _log(a: Val, b: Val, out_type: T.Type) -> Val:
    """log(base, x) (reference MathFunctions.log)."""
    base, x = _to_double(a), _to_double(b)
    ok = (x > 0) & (base > 0) & (base != 1)
    return Val(torch.log(x) / torch.log(base), and_valid(a.valid, b.valid, ok), T.DOUBLE)


@register("truncate", _same_as_first)
def _truncate(a: Val, out_type: T.Type) -> Val:
    """Truncate toward zero (reference MathFunctions.truncate)."""
    if T.is_floating(a.type):
        return Val(torch.trunc(a.data), a.valid, out_type)
    if isinstance(a.type, T.DecimalType):
        s = a.type.scale
        if s == 0:
            return a
        if a.data.ndim == 2:  # long decimal: drop the fraction exactly
            from ..ops import decimal128 as d128

            neg = a.data[..., 0] < 0
            mag = d128.dabs(a.data)
            p = s
            while p > 0:
                step = min(p, 9)
                mag, _ = d128._divmod_nonneg(mag, 10**step)
                p -= step
            mag = d128.rescale(mag, s)
            return Val(torch.where(neg[..., None], d128.dneg(mag), mag), a.valid, out_type)
        p = 10**s
        return Val((torch.abs(a.data) // p) * p * torch.sign(a.data), a.valid, out_type)
    return a


@register("width_bucket", _bigint_infer)
def _width_bucket(x: Val, lo: Val, hi: Val, n: Val, out_type: T.Type) -> Val:
    xv, lov, hiv = _to_double(x), _to_double(lo), _to_double(hi)
    nv = n.data.to(torch.int64)
    frac = (xv - lov) / (hiv - lov)
    b = torch.floor(frac * nv.to(torch.float64)).to(torch.int64) + 1
    b = torch.minimum(torch.clamp(b, min=0), nv + 1)
    return Val(b, and_valid(x.valid, lo.valid, hi.valid, n.valid), T.BIGINT)


def _nary_common_infer(ts):
    out = ts[0]
    for t2 in ts[1:]:
        out = T.common_super_type(out, t2)
    return out


def _minmax_nary(name, op, want_larger: bool):
    @register(name, _nary_common_infer)
    def _f(*vals, out_type: T.Type) -> Val:
        # NULL-propagating (reference greatest/least return NULL on any NULL)
        valid = and_valid(*[v.valid for v in vals])
        if isinstance(out_type, T.VarcharType):
            acc = vals[0]
            for v in vals[1:]:
                require_sorted_dict(acc, name)
                require_sorted_dict(v, name)
                xa, xb, did = unify_dictionaries(acc, v)
                acc = Val(op(xa, xb), None, out_type, did)
            return Val(acc.data, valid, out_type, acc.dict_id)
        if isinstance(out_type, T.DecimalType) and out_type.is_long:
            from ..ops import decimal128 as d128

            acc = _to_lanes(vals[0], out_type.scale)
            for v in vals[1:]:
                c = _to_lanes(v, out_type.scale)
                take = d128.dcmp_lt(acc, c) if want_larger else d128.dcmp_lt(c, acc)
                acc = torch.where(take[:, None], c, acc)
            return Val(acc, valid, out_type)
        from .compiler import _cast_val

        data = _cast_val(vals[0], out_type).data
        for v in vals[1:]:
            data = op(data, _cast_val(v, out_type).data)
        return Val(data, valid, out_type)

    return _f


_minmax_nary("greatest", torch.maximum, True)
_minmax_nary("least", torch.minimum, False)


# -- bitwise (reference operator/scalar/BitwiseFunctions.java) --------------
# Shift counts outside [0, 64) follow the reference's XLA semantics: a left
# or logical right shift gives 0, an arithmetic right shift the sign fill.

_INT64_MAX = (1 << 63) - 1


def shift_left(x, s):
    ok = (s >= 0) & (s < 64)
    return torch.where(ok, x << torch.clamp(s, 0, 63), torch.zeros_like(x))


def shift_right_logical(x, s):
    """x >>> s on int64 bit patterns (uint64 semantics)."""
    sc = torch.clamp(s, 1, 63)
    r = (x >> sc) & (_INT64_MAX >> (sc - 1))
    r = torch.where((s >= 1) & (s < 64), r, torch.zeros_like(x))
    return torch.where(s == 0, x, r)


def shift_right_arithmetic(x, s):
    ok = (s >= 0) & (s < 64)
    return torch.where(ok, x >> torch.clamp(s, 0, 63), torch.where(x < 0, -1, 0))


def _bitwise(name, fn):
    @register(name, _bigint_infer)
    def _f(a: Val, b: Val, out_type: T.Type) -> Val:
        x, y = a.data.to(torch.int64), b.data.to(torch.int64)
        return Val(fn(x, y), and_valid(a.valid, b.valid), T.BIGINT)

    return _f


_bitwise("bitwise_and", lambda x, y: x & y)
_bitwise("bitwise_or", lambda x, y: x | y)
_bitwise("bitwise_xor", lambda x, y: x ^ y)
_bitwise("bitwise_left_shift", shift_left)
_bitwise("bitwise_right_shift", shift_right_logical)
_bitwise("bitwise_arithmetic_shift_right", shift_right_arithmetic)


@register("bitwise_not", _bigint_infer)
def _bitwise_not(a: Val, out_type: T.Type) -> Val:
    return Val(~a.data.to(torch.int64), a.valid, T.BIGINT)


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def popcount64(x):
    """Set bits of each int64 (its 8 bytes through a 256-entry table)."""
    table = _table(_POPCOUNT8, torch.int64, x)
    b = x.contiguous().view(torch.uint8).to(torch.int64)
    return table[b].view(-1, 8).sum(dim=1)


@register("bit_count", _bigint_infer)
def _bit_count(a: Val, b: Val, out_type: T.Type) -> Val:
    """bit_count(x, bits) (reference BitwiseFunctions.bitCount)."""
    bits = int(_require_literal(b, "bit_count bits"))
    x = a.data.to(torch.int64)
    if bits < 64:
        x = x & ((1 << bits) - 1)
    return Val(popcount64(x), a.valid, T.BIGINT)


# ---------------------------------------------------------------------------
# string scalars, batch 2 (reference operator/scalar/StringFunctions.java)
# ---------------------------------------------------------------------------


def _dict_str_fn(name, fn, infer=_varchar_infer):
    @register(name, infer)
    def _f(a: Val, *rest, out_type: T.Type) -> Val:
        lits = [_require_literal(r, f"{name} argument") for r in rest]
        return _dict_transform(a, lambda s: fn(s, *lits))

    return _f


def _pad(s, n, pad, left):
    n = int(n)
    if len(s) >= n:
        return s[:n]
    fill = (pad * n)[: n - len(s)]
    return fill + s if left else s + fill


_dict_str_fn("reverse", lambda s: s[::-1], lambda ts: ts[0])
_dict_str_fn("ltrim", lambda s, *a: s.lstrip(*a))
_dict_str_fn("rtrim", lambda s, *a: s.rstrip(*a))
_dict_str_fn("replace", lambda s, old, new="": s.replace(old, new))
_dict_str_fn("lpad", lambda s, n, pad=" ": _pad(s, n, pad, True))
_dict_str_fn("rpad", lambda s, n, pad=" ": _pad(s, n, pad, False))


def _dict_table(a: Val, fn, dtype=torch.int64) -> torch.Tensor:
    """fn over every dictionary entry into a lookup table, gathered by code."""
    d = a.dictionary
    if d is None:
        raise TypeError("varchar value lost its dictionary")
    return _gather(_table([fn(s) for s in d], dtype, a.data), a.data)


@register("codepoint", _bigint_infer)
def _codepoint(a: Val, out_type: T.Type) -> Val:
    return Val(_dict_table(a, lambda s: ord(s[0]) if s else 0), a.valid, T.BIGINT)


@register("chr", _varchar_infer)
def _chr(a: Val, out_type: T.Type) -> Val:
    n = int(_require_literal(a, "chr codepoint"))
    return Val(torch.zeros_like(a.data, dtype=torch.int32), a.valid, T.VARCHAR,
               intern_dictionary((chr(n),)))


def levenshtein(s: str, target: str) -> int:
    prev = list(range(len(target) + 1))
    for i, cs in enumerate(s, 1):
        cur = [i]
        for j, ct in enumerate(target, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (cs != ct)))
        prev = cur
    return prev[-1]


@register("levenshtein_distance", _bigint_infer)
def _levenshtein(a: Val, b: Val, out_type: T.Type) -> Val:
    target = _require_literal(b, "levenshtein_distance target")
    return Val(_dict_table(a, lambda s: levenshtein(s, target)), a.valid, T.BIGINT)


@register("hamming_distance", _bigint_infer)
def _hamming(a: Val, b: Val, out_type: T.Type) -> Val:
    target = _require_literal(b, "hamming_distance target")

    def ham(s: str) -> int:
        if len(s) != len(target):
            return -1  # the reference raises; NULL here
        return sum(x != y for x, y in zip(s, target))

    got = _dict_table(a, ham)
    return Val(got, and_valid(a.valid, got >= 0), T.BIGINT)


# -- regexp (reference operator/scalar/Re2JRegexpFunctions / joni) ----------


@register("regexp_like", _bool_infer)
def _regexp_like(a: Val, pattern: Val, out_type: T.Type) -> Val:
    pat = re.compile(_require_literal(pattern, "regexp pattern"))
    return _dict_predicate(a, lambda s: pat.search(s) is not None)


@register("regexp_replace", _varchar_infer)
def _regexp_replace(a: Val, pattern: Val, *rest, out_type: T.Type) -> Val:
    pat = re.compile(_require_literal(pattern, "regexp pattern"))
    repl = _require_literal(rest[0], "replacement") if rest else ""
    repl = re.sub(r"\$(\d+)", r"\\\1", repl)  # $1 -> \1 group syntax
    return _dict_transform(a, lambda s: pat.sub(repl, s))


@register("regexp_extract", _varchar_infer)
def _regexp_extract(a: Val, pattern: Val, *rest, out_type: T.Type) -> Val:
    pat = re.compile(_require_literal(pattern, "regexp pattern"))
    group = int(_require_literal(rest[0], "group")) if rest else 0

    def f(s: str):
        m = pat.search(s)
        g = None if m is None else m.group(group)
        return ("", False) if g is None else (g, True)

    return _dict_transform_nullable(a, f)


@register("regexp_count", _bigint_infer)
def _regexp_count(a: Val, pattern: Val, out_type: T.Type) -> Val:
    pat = re.compile(_require_literal(pattern, "regexp pattern"))
    return Val(_dict_table(a, lambda s: len(pat.findall(s))), a.valid, T.BIGINT)


def _dict_transform_nullable(a: Val, fn, out_type=T.VARCHAR) -> Val:
    """Like _dict_transform but fn returns (string, ok); not-ok entries
    come out NULL."""
    d = a.dictionary
    if d is None:
        raise TypeError("varchar value lost its dictionary")
    pairs = [fn(s) for s in d]
    values = [v if ok else "" for v, ok in pairs]
    new_dict = tuple(sorted(set(values)))
    index = {s: i for i, s in enumerate(new_dict)}
    codes = _table([index[v] for v in values], torch.int32, a.data)
    oks = _table([bool(ok) for _, ok in pairs], torch.bool, a.data)
    return Val(_gather(codes, a.data), and_valid(a.valid, _gather(oks, a.data)),
               out_type, intern_dictionary(new_dict))


def _dict_table_nullable(a: Val, fn, np_dtype, out_type: T.Type) -> Val:
    """Numeric sibling of _dict_transform_nullable: fn(entry) -> (value, ok)
    per dictionary entry into a lookup table; not-ok entries come out NULL."""
    d = a.dictionary
    if d is None:
        raise TypeError("varchar value lost its dictionary")
    values = np.zeros(len(d), np_dtype)
    ok = np.zeros(len(d), np.bool_)
    for i, s in enumerate(d):
        v, good = fn(s)
        if good:
            values[i] = v
            ok[i] = True
    table = _table(values, out_type.storage_dtype, a.data)
    oktab = _table(ok, torch.bool, a.data)
    return Val(_gather(table, a.data), and_valid(a.valid, _gather(oktab, a.data)), out_type)


# ---------------------------------------------------------------------------
# datetime scalars, batch 2 (reference operator/scalar/DateTimeFunctions.java)
# ---------------------------------------------------------------------------

_DAY_US = 86400 * _TS_US


def _iso_thursday(days):
    """The Thursday of each day's ISO week (day numbers, int64)."""
    return days - ((days + 3) % 7) + 3


@register("week", _bigint_infer)
def _week(a: Val, out_type: T.Type) -> Val:
    """ISO-8601 week number (reference DateTimeFunctions.weekFromDate)."""
    thursday = _iso_thursday(a.data.to(torch.int64))
    y, _, _ = dt.days_to_civil(thursday)
    jan1 = dt.civil_to_days(y, torch.ones_like(y), torch.ones_like(y))
    return Val((thursday - jan1) // 7 + 1, a.valid, T.BIGINT)


_alias("week_of_year", "week")


def _date_infer(ts):
    return T.DATE


@register("last_day_of_month", _date_infer)
def _last_day_of_month_fn(a: Val, out_type: T.Type) -> Val:
    y, m, _ = dt.days_to_civil(a.data.to(torch.int64))
    out = dt.civil_to_days(y, m, dt.last_day_of_month(y, m))
    return Val(out.to(torch.int32), a.valid, T.DATE)


def _time_field(name, per, mod):
    @register(name, _bigint_infer)
    def _f(a: Val, out_type: T.Type) -> Val:
        if isinstance(a.type, T.DateType):
            return Val(torch.zeros_like(a.data, dtype=torch.int64), a.valid, T.BIGINT)
        return Val((a.data.to(torch.int64) // per) % mod, a.valid, T.BIGINT)

    return _f


_time_field("hour", 3600 * _TS_US, 24)
_time_field("minute", 60 * _TS_US, 60)
_time_field("second", _TS_US, 60)


@register("millisecond", _bigint_infer)
def _millisecond(a: Val, out_type: T.Type) -> Val:
    return Val((a.data.to(torch.int64) // 1000) % 1000, a.valid, T.BIGINT)


_TS_UNITS = {
    "second": _TS_US,
    "minute": 60 * _TS_US,
    "hour": 3600 * _TS_US,
    "day": _DAY_US,
    "week": 7 * _DAY_US,
}


@register("date_trunc", lambda ts: ts[1])
def _date_trunc(unit: Val, a: Val, out_type: T.Type) -> Val:
    u = _require_literal(unit, "date_trunc unit").lower()
    if isinstance(a.type, T.TimestampType):
        per = _TS_UNITS.get(u) if u != "week" else None
        if per is None:
            raise NotImplementedError(f"date_trunc({u!r}) on timestamp")
        us = a.data.to(torch.int64)
        return Val((us // per) * per, a.valid, a.type)
    days = a.data.to(torch.int64)
    y, m, _ = dt.days_to_civil(days)
    one = torch.ones_like(y)
    if u == "day":
        out = days
    elif u == "week":
        out = days - (days + 3) % 7  # back to Monday
    elif u == "month":
        out = dt.civil_to_days(y, m, one)
    elif u == "quarter":
        out = dt.civil_to_days(y, ((m - 1) // 3) * 3 + 1, one)
    elif u == "year":
        out = dt.civil_to_days(y, one, one)
    else:
        raise NotImplementedError(f"date_trunc unit {u!r}")
    return Val(out.to(torch.int32), a.valid, T.DATE)


@register("date_add", lambda ts: ts[2])  # result type = the datetime arg's
def _date_add(unit: Val, n: Val, a: Val, out_type: T.Type) -> Val:
    u = _require_literal(unit, "date_add unit").lower()
    amount = n.data.to(torch.int64)
    valid = and_valid(a.valid, n.valid)
    if isinstance(a.type, T.TimestampType):
        per = _TS_UNITS.get(u)
        if per is None:
            raise NotImplementedError(f"date_add({u!r}) on timestamp")
        return Val(a.data + amount * per, valid, a.type)
    days = a.data.to(torch.int64)
    months = {"month": 1, "quarter": 3, "year": 12}
    if u == "day":
        out = days + amount
    elif u == "week":
        out = days + 7 * amount
    elif u in months:
        out = dt.add_months(days, months[u] * amount)
    else:
        raise NotImplementedError(f"date_add unit {u!r}")
    return Val(out.to(torch.int32), valid, T.DATE)


def _toward_zero(delta, per):
    return torch.sign(delta) * (torch.abs(delta) // per)


@register("date_diff", _bigint_infer)
def _date_diff(unit: Val, a: Val, b: Val, out_type: T.Type) -> Val:
    u = _require_literal(unit, "date_diff unit").lower()
    valid = and_valid(a.valid, b.valid)
    if isinstance(a.type, T.TimestampType) or isinstance(b.type, T.TimestampType):
        per = _TS_UNITS.get(u)
        if per is None:
            raise NotImplementedError(f"date_diff({u!r}) on timestamp")
        # truncate toward zero (reference DateTimeFunctions.diff semantics)
        return Val(_toward_zero(b.data - a.data, per), valid, T.BIGINT)
    d1, d2 = a.data.to(torch.int64), b.data.to(torch.int64)
    if u == "day":
        out = d2 - d1
    elif u == "week":
        out = _toward_zero(d2 - d1, 7)
    elif u in ("month", "quarter", "year"):
        y1, m1, dd1 = dt.days_to_civil(d1)
        y2, m2, dd2 = dt.days_to_civil(d2)
        months = (y2 - y1).to(torch.int64) * 12 + (m2 - m1)
        # partial months don't count (reference: diffMonth truncates), but
        # the reference's month and year then floor-divide
        months = (months - ((d2 >= d1) & (dd2 < dd1)).to(torch.int64)
                  + ((d2 < d1) & (dd2 > dd1)).to(torch.int64))
        out = {"month": months, "quarter": months // 3, "year": months // 12}[u]
    else:
        raise NotImplementedError(f"date_diff unit {u!r}")
    return Val(out, valid, T.BIGINT)


@register("year_of_week", _bigint_infer)
def _year_of_week(a: Val, out_type: T.Type) -> Val:
    """ISO week-numbering year (reference DateTimeFunctions.yearOfWeek)."""
    if isinstance(a.type, T.TimestampType):
        days = a.data.to(torch.int64) // _DAY_US
    else:
        days = a.data.to(torch.int64)
    y, _, _ = dt.days_to_civil(_iso_thursday(days))
    return Val(y.to(torch.int64), a.valid, T.BIGINT)


_alias("yow", "year_of_week")


@register("from_unixtime", lambda ts: T.TIMESTAMP)
def _from_unixtime(a: Val, out_type: T.Type) -> Val:
    return Val((_to_double(a) * _TS_US).to(torch.int64), a.valid, T.TIMESTAMP)


@register("to_unixtime", _double_infer)
def _to_unixtime(a: Val, out_type: T.Type) -> Val:
    if isinstance(a.type, T.DateType):
        return Val(a.data.to(torch.float64) * 86400.0, a.valid, T.DOUBLE)
    return Val(a.data.to(torch.float64) / _TS_US, a.valid, T.DOUBLE)


# split_part returns NULL past the last field (reference
# StringFunctions.splitPart)
@register("split_part", _varchar_infer)
def _split_part(a: Val, delim: Val, index: Val, out_type: T.Type) -> Val:
    d = _require_literal(delim, "split_part delimiter")
    i = int(_require_literal(index, "split_part index"))
    if i < 1:
        raise ValueError("split_part index must be >= 1")

    def f(s: str):
        parts = s.split(d)
        return (parts[i - 1], True) if i <= len(parts) else ("", False)

    return _dict_transform_nullable(a, f)


_DATE_FMT_BASE = -141427  # 1582-10-15 (Gregorian adoption)
_DATE_FMT_N = 335371  # through 2500-12-31
_DATE_FMT_CACHE: dict = {}
_MONTHS = ("January", "February", "March", "April", "May", "June", "July", "August",
           "September", "October", "November", "December")
_WEEKDAYS = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday", "Sunday")


def _day_fields():
    """Year, month, day of month, day of year and weekday (Monday 0) of
    every day of the table's window, as numpy int64 arrays."""
    days = np.arange(_DATE_FMT_N, dtype=np.int64) + _DATE_FMT_BASE
    d = days.astype("M8[D]")
    return {
        "y": d.astype("M8[Y]").astype(np.int64) + 1970,
        "m": d.astype("M8[M]").astype(np.int64) % 12 + 1,
        "dom": (d - d.astype("M8[M]")).astype(np.int64) + 1,
        "doy": (d - d.astype("M8[Y]")).astype(np.int64) + 1,
        "wd": (days + 3) % 7,
    }


def _digits(width):
    table = np.array([f"{i:0{width}d}" for i in range(10**width)])
    return lambda v: table[v]


_NUM = np.array([str(i) for i in range(400)])
# the specifiers of the two pattern syntaxes over a date (a date has no
# time, so the time fields are their midnight values): MySQL's, as
# date_format takes them (reference DateTimeFunctions.DATE_FORMATTER), and
# strftime's, into which format_datetime's Joda patterns translate
_MYSQL_SPECS = {
    "Y": lambda f: _digits(4)(f["y"]), "y": lambda f: _digits(2)(f["y"] % 100),
    "m": lambda f: _digits(2)(f["m"]), "c": lambda f: _NUM[f["m"]],
    "d": lambda f: _digits(2)(f["dom"]), "e": lambda f: _NUM[f["dom"]],
    "j": lambda f: _digits(3)(f["doy"]),
    "M": lambda f: np.array(_MONTHS)[f["m"] - 1],
    "b": lambda f: np.array([x[:3] for x in _MONTHS])[f["m"] - 1],
    "W": lambda f: np.array(_WEEKDAYS)[f["wd"]],
    "a": lambda f: np.array([x[:3] for x in _WEEKDAYS])[f["wd"]],
    "H": "00", "i": "00", "s": "00", "%": "%",
}
_STRFTIME_SPECS = {
    "Y": _MYSQL_SPECS["Y"], "y": _MYSQL_SPECS["y"], "m": _MYSQL_SPECS["m"],
    "d": _MYSQL_SPECS["d"], "j": _MYSQL_SPECS["j"], "B": _MYSQL_SPECS["M"],
    "b": _MYSQL_SPECS["b"], "A": _MYSQL_SPECS["W"], "a": _MYSQL_SPECS["a"],
    "H": "00", "I": "12", "M": "00", "S": "00", "f": "000000", "p": "AM", "%": "%",
}


def _date_format_table(fmt: str, specs, what: str):
    """day-number -> formatted-string mapping over 1582..2500 for a
    %-pattern, deduped into a sorted dictionary: (dictionary, int32 codes).
    Built with numpy string arrays, one pass per specifier, then cached per
    (syntax, pattern); equal strings map to equal codes."""
    key = (what, fmt)
    cached = _DATE_FMT_CACHE.get(key)
    if cached is None:
        fields = _day_fields()
        out = np.full(_DATE_FMT_N, "", dtype="U1")
        text = []
        i = 0
        while i < len(fmt):
            if fmt[i] == "%" and i + 1 < len(fmt):
                spec = specs.get(fmt[i + 1])
                if spec is None:
                    raise NotImplementedError(f"{what} specifier %{fmt[i + 1]}")
                part = spec if isinstance(spec, str) else spec(fields)
                i += 2
            else:
                part = fmt[i]
                i += 1
            if isinstance(part, str):
                text.append(part)
                continue
            out = np.char.add(np.char.add(out, "".join(text)), part)
            text = []
        out = np.char.add(out, "".join(text))
        dictionary, codes = np.unique(out, return_inverse=True)
        cached = (tuple(str(x) for x in dictionary), codes.astype(np.int32))
        _DATE_FMT_CACHE[key] = cached
    return cached


def _days_of(a: Val, what: str, time_specs, fmt: str):
    if isinstance(a.type, T.TimestampType):
        if any(spec in fmt for spec in time_specs):
            raise NotImplementedError(f"{what} with time-of-day specifiers on timestamp")
        return a.data.to(torch.int64) // _DAY_US
    if isinstance(a.type, T.DateType):
        return a.data.to(torch.int64)
    raise TypeError(f"{what} on {a.type}")


def _format_days(a: Val, days, table) -> Val:
    dictionary, mapping = table
    off = days - _DATE_FMT_BASE
    in_range = (off >= 0) & (off < _DATE_FMT_N)
    codes = _gather(_table(mapping, torch.int32, days), torch.clamp(off, 0, _DATE_FMT_N - 1))
    # dates outside the precomputed 1582..2500 table come out NULL rather
    # than clamped to a boundary date's string
    return Val(codes, and_valid(a.valid, in_range), T.VARCHAR, intern_dictionary(dictionary))


@register("date_format", _varchar_infer)
def _date_format(a: Val, fmt: Val, out_type: T.Type) -> Val:
    f = _require_literal(fmt, "date_format format")
    days = _days_of(a, "date_format", ("%H", "%i", "%s", "%f", "%T", "%r", "%h"), f)
    return _format_days(a, days, _date_format_table(f, _MYSQL_SPECS, "date_format"))


def _mysql_to_strptime(fmt: str) -> str:
    """MySQL date_parse format -> python strptime format."""
    table = {
        "Y": "%Y", "y": "%y", "m": "%m", "c": "%m", "d": "%d", "e": "%d",
        "H": "%H", "i": "%M", "s": "%S", "j": "%j", "M": "%B", "b": "%b",
        "%": "%%",
    }
    out = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            if spec not in table:
                raise NotImplementedError(f"date_parse specifier %{spec}")
            out.append(table[spec])
            i += 2
        else:
            out.append(c.replace("%", "%%"))
            i += 1
    return "".join(out)


def _strptime_micros(fmt: str):
    """s -> (epoch microseconds, ok) under a strptime format."""
    import datetime as _dt

    epoch = _dt.datetime(1970, 1, 1)

    def parse(s: str):
        try:
            return int((_dt.datetime.strptime(s, fmt) - epoch).total_seconds() * _TS_US), True
        except ValueError:
            return 0, False

    return parse


@register("date_parse", lambda ts: T.TIMESTAMP)
def _date_parse(a: Val, fmt: Val, out_type: T.Type) -> Val:
    f = _mysql_to_strptime(_require_literal(fmt, "date_parse format"))
    return _dict_table_nullable(a, _strptime_micros(f), np.int64, T.TIMESTAMP)


@register("from_iso8601_date", _date_infer)
def _from_iso8601_date(a: Val, out_type: T.Type) -> Val:
    def parse(s: str):
        try:
            return dt.parse_date_literal(s), True
        except Exception:  # noqa: BLE001 — malformed input -> SQL NULL
            return 0, False

    return _dict_table_nullable(a, parse, np.int32, T.DATE)


# -- JSON (reference operator/scalar/JsonFunctions.java, JsonExtract.java;
# JSON values are varchar here — evaluated once per dictionary entry) -------


def _json_path_steps(path: str):
    """Parse the JsonPath subset $.a.b[0]["c"] into access steps."""
    if not path.startswith("$"):
        raise ValueError(f"invalid JSON path {path!r}")
    steps = []
    i, n = 1, len(path)
    while i < n:
        c = path[i]
        if c == ".":
            j = i + 1
            while j < n and path[j] not in ".[":
                j += 1
            steps.append(path[i + 1 : j])
            i = j
        elif c == "[":
            j = path.index("]", i)
            inner = path[i + 1 : j].strip()
            steps.append(inner[1:-1] if inner[:1] in ("'", '"') else int(inner))
            i = j + 1
        else:
            raise ValueError(f"invalid JSON path {path!r}")
    return steps


def _json_loads(s: str):
    """(value, ok): malformed JSON is SQL NULL."""
    import json

    try:
        return json.loads(s), True
    except Exception:  # noqa: BLE001 — malformed JSON -> SQL NULL
        return None, False


def _json_get(s: str, steps):
    v, ok = _json_loads(s)
    if not ok:
        return None, False
    for step in steps:
        if isinstance(step, int):
            if not isinstance(v, list) or not (-len(v) <= step < len(v)):
                return None, False
        elif not isinstance(v, dict) or step not in v:
            return None, False
        v = v[step]
    return v, True


@register("json_extract_scalar", _varchar_infer)
def _json_extract_scalar(a: Val, path: Val, out_type: T.Type) -> Val:
    import json

    steps = _json_path_steps(_require_literal(path, "JSON path"))

    def f(s: str):
        v, ok = _json_get(s, steps)
        if not ok or isinstance(v, (dict, list)) or v is None:
            return "", False
        # strings unquoted; numbers/booleans keep their JSON text
        return (v if isinstance(v, str) else json.dumps(v)), True

    return _dict_transform_nullable(a, f)


@register("json_extract", _varchar_infer)
def _json_extract(a: Val, path: Val, out_type: T.Type) -> Val:
    import json

    steps = _json_path_steps(_require_literal(path, "JSON path"))

    def f(s: str):
        v, ok = _json_get(s, steps)
        return (json.dumps(v, separators=(",", ":"), sort_keys=True), True) if ok else ("", False)

    return _dict_transform_nullable(a, f)


@register("json_array_length", _bigint_infer)
def _json_array_length(a: Val, out_type: T.Type) -> Val:
    def f(s: str):
        v, ok = _json_loads(s)
        return (len(v), True) if ok and isinstance(v, list) else (0, False)

    return _dict_table_nullable(a, f, np.int64, T.BIGINT)


@register("json_array_contains", _bool_infer)
def _json_array_contains(a: Val, needle: Val, out_type: T.Type) -> Val:
    want = _require_literal(needle, "json_array_contains value")

    def f(s: str):
        # NULL (not false) for invalid JSON and non-arrays (reference
        # JsonFunctions is @SqlNullable)
        v, ok = _json_loads(s)
        if not ok or not isinstance(v, list):
            return False, False
        if isinstance(want, bool):
            return any(x is want for x in v), True
        if isinstance(want, (int, float)):
            return any(not isinstance(x, bool) and isinstance(x, (int, float)) and x == want
                       for x in v), True
        return any(isinstance(x, str) and x == want for x in v), True

    return _dict_table_nullable(a, f, np.bool_, T.BOOLEAN)


@register("json_format", _varchar_infer)
def _json_format(a: Val, out_type: T.Type) -> Val:
    import json

    def f(s: str) -> str:
        v, ok = _json_loads(s)
        # non-JSON passes through verbatim (reference json_format)
        return json.dumps(v, separators=(",", ":")) if ok else s

    return _dict_transform(a, f)


# -- URL (reference operator/scalar/UrlFunctions.java) ----------------------


def _url_host_raw(u) -> str:
    """Case-preserving host: urlparse().hostname lowercases, the reference
    keeps the authority as written."""
    netloc = u.netloc
    if "@" in netloc:
        netloc = netloc.rsplit("@", 1)[1]
    if netloc.startswith("["):  # [ipv6]:port
        return netloc.split("]", 1)[0] + "]"
    return netloc.split(":", 1)[0]


def _url_part(name: str, getter):
    """getter(parse_result, raw) -> str or None; None or a parse failure is
    NULL (reference UrlFunctions returns null for absent components)."""

    @register(name, _varchar_infer)
    def _f(a: Val, out_type: T.Type) -> Val:
        from urllib.parse import urlparse

        def f(s: str):
            try:
                v = getter(urlparse(s), s)
            except Exception:  # noqa: BLE001 — unparseable URL -> SQL NULL
                return "", False
            return (v, True) if v is not None else ("", False)

        return _dict_transform_nullable(a, f)

    return _f


_url_part("url_extract_host", lambda u, s: _url_host_raw(u) or None)
_url_part("url_extract_protocol", lambda u, s: u.scheme or None)
_url_part("url_extract_path", lambda u, s: u.path)
_url_part("url_extract_query", lambda u, s: u.query if "?" in s.split("#", 1)[0] else None)
_url_part("url_extract_fragment", lambda u, s: u.fragment if "#" in s else None)


@register("url_extract_port", _bigint_infer)
def _url_extract_port(a: Val, out_type: T.Type) -> Val:
    from urllib.parse import urlparse

    def f(s: str):
        try:
            p = urlparse(s).port
        except Exception:  # noqa: BLE001 — invalid port -> SQL NULL
            p = None
        return (p, True) if p is not None else (0, False)

    return _dict_table_nullable(a, f, np.int64, T.BIGINT)


@register("url_encode", _varchar_infer)
def _url_encode(a: Val, out_type: T.Type) -> Val:
    from urllib.parse import quote_plus

    return _dict_transform(a, quote_plus)


@register("url_decode", _varchar_infer)
def _url_decode(a: Val, out_type: T.Type) -> Val:
    from urllib.parse import unquote_plus

    return _dict_transform(a, unquote_plus)


# ---------------------------------------------------------------------------
# arrays and maps (reference operator/scalar/ArrayFunctions.java +
# ArrayConstructor, ArraySubscriptOperator, SequenceFunction,
# StringFunctions.split, MapConstructor). An array value is (capacity,
# width) data + per-row lengths; a map adds its keys as a companion array.
# ---------------------------------------------------------------------------


def array_lengths(a: Val) -> torch.Tensor:
    """Per-row lengths; a fixed-width array without them has every lane live."""
    if a.lengths is not None:
        return a.lengths
    return torch.full(a.data.shape[:1], a.data.shape[1], dtype=torch.int32, device=a.device)


def array_in_bounds(a: Val) -> torch.Tensor:
    """(rows, width) mask of the lanes inside each row's length."""
    lane = torch.arange(a.data.shape[1], device=a.device)
    return lane[None, :] < array_lengths(a)[:, None]


def lane_compaction(keep: torch.Tensor) -> torch.Tensor:
    """Per-row order that moves the kept lanes to the front, in order."""
    return torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)


def widen_lanes(x: Optional[torch.Tensor], width: int) -> Optional[torch.Tensor]:
    """Zero-pad the lane axis (axis 1) of a collection tensor to `width`."""
    if x is None or x.shape[1] >= width:
        return x
    pad = torch.zeros((x.shape[0], width - x.shape[1]) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


@register("array_constructor", lambda ts: T.ArrayType(ts[0] if ts else T.UNKNOWN))
def _array_constructor(*vals, out_type: T.Type) -> Val:
    if not vals:
        raise NotImplementedError("empty ARRAY[] requires a typed context")
    did = None
    if isinstance(out_type.element, T.VarcharType):
        # varchar elements may arrive with different dictionaries (literals
        # intern as singletons): remap all onto one
        acc = vals[0]
        for v in vals[1:]:
            xa, _xb, did = unify_dictionaries(acc, v)
            acc = Val(xa, acc.valid, acc.type, did)
        did = acc.dict_id
        data = torch.stack([unify_dictionaries(v, acc)[0] for v in vals], dim=1)
    else:
        dtype = out_type.element.storage_dtype
        data = torch.stack([v.data.to(dtype) for v in vals], dim=1)
    evalid = None
    if any(v.valid is not None for v in vals):
        evalid = torch.stack([v.valid_mask() for v in vals], dim=1)
    lengths = torch.full(vals[0].data.shape[:1], len(vals), dtype=torch.int32,
                         device=vals[0].device)
    return Val(data, None, out_type, did, lengths=lengths, elem_valid=evalid)


def dict_split_val(a: Val, parts_per, what: str) -> Val:
    """array(varchar) from one host split per DICTIONARY entry: the parts
    of entry i are parts_per[i]; codes and lengths are per-entry tables
    gathered by the column's codes."""
    d = a.dictionary
    width = max((len(p) for p in parts_per), default=1) or 1
    out_dict = tuple(sorted({p for parts in parts_per for p in parts}))
    index = {x: i for i, x in enumerate(out_dict)}
    codes = np.zeros((max(len(d), 1), width), np.int32)
    lens = np.zeros(max(len(d), 1), np.int32)
    for i, parts in enumerate(parts_per):
        lens[i] = len(parts)
        codes[i, :len(parts)] = [index[x] for x in parts]
    c = a.data.to(torch.int64)
    return Val(_table(codes, torch.int32, a.data)[c], a.valid, T.ArrayType(T.VARCHAR),
               intern_dictionary(out_dict), lengths=_table(lens, torch.int32, a.data)[c])


def _require_dictionary(a: Val, what: str):
    d = a.dictionary
    if d is None:
        raise TypeError(f"{what}: varchar value lost its dictionary")
    return d


@register("split", lambda ts: T.ArrayType(T.VARCHAR))
def _split(a: Val, delim: Val, *rest, out_type: T.Type) -> Val:
    """split(str, delim [, limit]) -> array(varchar): each dictionary entry
    splits once on the host."""
    d = _require_dictionary(a, "split")
    sep = _require_literal(delim, "split delimiter")
    limit = int(_require_literal(rest[0], "split limit")) if rest else None
    parts = [(x.split(sep, limit - 1) if limit else x.split(sep)) for x in d]
    return dict_split_val(a, parts, "split")


@register("cardinality", _bigint_infer)
def _cardinality(a: Val, out_type: T.Type) -> Val:
    if getattr(a.type, "sketch", None) == "hll":
        from ..ops.aggregate import hll_estimate

        return Val(hll_estimate(a.data), a.valid, T.BIGINT)
    if a.lengths is None:
        raise TypeError("cardinality requires an array value")
    return Val(a.lengths.to(torch.int64), a.valid, T.BIGINT)


def _array_elem_eq(a: Val, needle: Val, what: str):
    """(eq, in_len) matrices of element-vs-needle comparison. A varchar
    needle with another dictionary must be a literal; it resolves against
    the array's sorted dictionary."""
    if a.lengths is None:
        raise TypeError(f"{what} requires an array value")
    lane = torch.arange(a.data.shape[1], dtype=torch.int32, device=a.device)
    in_len = lane[None, :] < torch.clamp(a.lengths, min=0)[:, None]
    if isinstance(needle.type, T.VarcharType) and needle.dict_id != a.dict_id:
        require_sorted_dict(a, what)
        lit = _require_literal(needle, f"{what} needle")
        d = a.dictionary or ()
        code = _bisect(d, lit, "left")
        if code < len(d) and d[code] == lit:
            eq = a.data == code
        else:
            eq = torch.zeros(a.data.shape, dtype=torch.bool, device=a.device)
    else:
        nd = needle.data
        if nd.ndim == 0:
            nd = nd.expand(a.data.shape[0])
        eq = a.data == nd[:, None]
    return eq, in_len


@register("contains", _bool_infer)
def _contains(a: Val, needle: Val, out_type: T.Type) -> Val:
    eq, in_len = _array_elem_eq(a, needle, "contains")
    null_elem = torch.zeros(in_len.shape[0], dtype=torch.bool, device=a.device)
    if a.elem_valid is not None:
        eq = eq & a.elem_valid
        null_elem = (~a.elem_valid & in_len).any(dim=1)
    hit = (eq & in_len).any(dim=1)
    # three-valued: not found but a NULL element present -> NULL
    valid = and_valid(a.valid, needle.valid, hit | ~null_elem)
    return Val(hit, valid, T.BOOLEAN)


@register("array_position", _bigint_infer)
def _array_position(a: Val, needle: Val, out_type: T.Type) -> Val:
    """1-based index of the first match, 0 when absent."""
    eq, in_len = _array_elem_eq(a, needle, "array_position")
    if a.elem_valid is not None:
        eq = eq & a.elem_valid
    eq = eq & in_len
    first = torch.where(eq.any(dim=1), eq.to(torch.uint8).argmax(dim=1) + 1, 0)
    return Val(first.to(torch.int64), and_valid(a.valid, needle.valid), T.BIGINT)


def _map_element_at(m: Val, k: Val, out_type: T.Type) -> Val:
    eq, in_len = _array_elem_eq(m.keys, k, "map key lookup")
    hit = eq & in_len
    found = hit.any(dim=1)
    pos = hit.to(torch.uint8).argmax(dim=1)
    data = torch.gather(m.data, 1, pos[:, None])[:, 0]
    valid = and_valid(m.valid, k.valid, found)
    if m.elem_valid is not None:
        valid = and_valid(valid, torch.gather(m.elem_valid, 1, pos[:, None])[:, 0])
    return Val(data, valid, out_type, m.dict_id)


@register("map", lambda ts: T.MapType(ts[0].element, ts[1].element))
def _map_constructor(karr: Val, varr: Val, out_type: T.Type) -> Val:
    """map(key_array, value_array) (reference MapConstructor). Arrays of
    unequal length give a NULL map, as in the JAX package (the reference
    raises)."""
    if karr.lengths is None or varr.lengths is None:
        raise TypeError("map() takes two array arguments")
    valid = and_valid(karr.valid, varr.valid, karr.lengths == varr.lengths)
    w = max(karr.data.shape[1], varr.data.shape[1])
    keys = Val(widen_lanes(karr.data, w), None, T.ArrayType(out_type.key), karr.dict_id,
               lengths=karr.lengths, elem_valid=widen_lanes(karr.elem_valid, w))
    return Val(widen_lanes(varr.data, w), valid, out_type, varr.dict_id,
               lengths=karr.lengths, elem_valid=widen_lanes(varr.elem_valid, w), keys=keys)


@register("map_keys", lambda ts: T.ArrayType(ts[0].key))
def _map_keys(m: Val, out_type: T.Type) -> Val:
    k = m.keys
    return Val(k.data, m.valid, out_type, k.dict_id, lengths=m.lengths,
               elem_valid=k.elem_valid)


@register("map_values", lambda ts: T.ArrayType(ts[0].value))
def _map_values(m: Val, out_type: T.Type) -> Val:
    return Val(m.data, m.valid, out_type, m.dict_id, lengths=m.lengths,
               elem_valid=m.elem_valid)


@register("sequence", lambda ts: T.ArrayType(ts[0]))
def _sequence(a: Val, b: Val, *rest, out_type: T.Type) -> Val:
    """sequence(start, stop [, step]) with literal bounds."""
    start = int(_require_literal(a, "sequence start"))
    stop = int(_require_literal(b, "sequence stop"))
    if rest:
        step = int(_require_literal(rest[0], "sequence step"))
    else:
        step = 1 if stop >= start else -1  # Presto: implicit descending
    if step == 0:
        raise ValueError("sequence step must be non-zero")
    if (stop - start) * step < 0:
        # reference SequenceFunction: the step must move toward stop
        raise ValueError(f"sequence step {step} cannot reach stop {stop} from {start}")
    values = list(range(start, stop + (1 if step > 0 else -1), step))
    cap = a.data.shape[0]
    row = _table(np.array(values, np.int64), torch.int64, a.data)
    return Val(row[None, :].expand(cap, len(values)), None, out_type,
               lengths=torch.full((cap,), len(values), dtype=torch.int32, device=a.device))


# the long tail (math, string, digest, JSON, clock and report helpers of
# presto_tpu/expr/functions_ext.py) registers on import
from . import functions_ext  # noqa: E402,F401  (registration side effects)


# every name of the JAX package's registry is ported (kept for callers that
# list what is left)
NOT_PORTED = ()
