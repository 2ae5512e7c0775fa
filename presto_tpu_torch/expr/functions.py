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

Every function of the JAX package's registry is known here by name:
the ported ones evaluate, the rest (`NOT_PORTED`) raise a "not ported yet"
error at planning time instead of an unknown-function error.
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
    # array/map values only (not ported yet; kept for layout parity)
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
    lanes = v.data if v.data.ndim == 2 else d128.from_int64(v.data.to(torch.int64))
    return d128.rescale(lanes, to_scale - s)


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
    out of range -> NULL (element_at's forgiving semantics). The MAP form
    (key lookup) is not ported yet."""
    if isinstance(a.type, T.MapType):
        raise NotPortedError("not ported yet: element_at over a map")
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
# not ported yet: the rest of presto_tpu's registry (expr/functions.py past
# the sections above, and expr/functions_ext.py)
# ---------------------------------------------------------------------------

NOT_PORTED = tuple(
    """
acosh array_concat array_constructor array_distinct array_except
array_intersect array_max array_min array_position array_remove array_sort
array_union arrays_overlap asinh atan2 atanh bar beta_cdf binomial_cdf
bit_count bitwise_and bitwise_arithmetic_shift_right bitwise_left_shift
bitwise_logical_shift_right bitwise_not bitwise_or bitwise_right_shift
bitwise_xor cardinality cauchy_cdf cbrt ceiling char2hexint char_length
character_length chi_squared_cdf chr classify codepoint color concat_ws
contains cosine_distance cosine_similarity cot crc32 current_date
current_timestamp current_timezone date_add date_diff date_format date_parse
date_trunc e expm1 format_datetime from_base from_base64
from_base64url from_big_endian_64 from_hex from_ieee754_32 from_ieee754_64
from_iso8601_date from_iso8601_timestamp from_unixtime from_utf8 gamma_cdf
great_circle_distance greatest hamming_distance hmac_md5 hmac_sha1
hmac_sha256 hmac_sha512 hour human_readable_seconds index infinity
inverse_beta_cdf inverse_normal_cdf is_json_scalar json_array_contains
json_array_get json_array_length json_extract json_extract_scalar
json_format json_parse json_size laplace_cdf last_day_of_month lcase least
levenshtein_distance localtimestamp log log1p lpad ltrim map map_concat
map_keys map_values md5 millisecond minute nan normal_cdf normalize now
parse_datetime parse_duration parse_presto_data_size pi poisson_cdf position
pow quantile_at_value regexp_count regexp_extract regexp_extract_all
regexp_like regexp_replace regexp_split regress render repeat replace
reverse rgb rpad rtrim second sequence sha1 sha256 sha512 slice split
split_part split_to_map spooky_hash_v2_32 spooky_hash_v2_64 st_area
st_centroid st_contains st_disjoint st_distance st_envelope
st_geometryfromtext st_intersects st_isclosed st_isempty st_length
st_linefromtext st_numpoints st_perimeter st_point st_polygon st_within st_x
st_xmax st_xmin st_y st_ymax st_ymin strrpos timezone_hour timezone_minute
to_base to_base64 to_base64url to_big_endian_64 to_hex to_ieee754_32
to_ieee754_64 to_iso8601 to_milliseconds to_unixtime to_utf8 translate
truncate typeof ucase url_decode url_encode url_extract_fragment
url_extract_host url_extract_parameter url_extract_path url_extract_port
url_extract_protocol url_extract_query value_at_quantile week week_of_year
weibull_cdf width_bucket wilson_interval_lower wilson_interval_upper
word_stem xxhash64 year_of_week yow
""".split()
)


def _not_ported(name):
    def infer(ts):
        raise NotPortedError(f"not ported yet: function {name!r}")

    def impl(*vals, out_type):
        raise NotPortedError(f"not ported yet: function {name!r}")

    FUNCTIONS[name] = ScalarFunction(name, infer, impl)


for _name in NOT_PORTED:
    if _name not in FUNCTIONS:
        _not_ported(_name)
