"""Expression evaluator: typed RowExpression -> torch tensors.

Counterpart of presto_tpu/expr/compiler.py and, like it, the equivalent of the
reference's runtime bytecode generation
(presto-main/.../sql/gen/ExpressionCompiler.java:93). PyTorch runs eagerly,
so `evaluate` walks the tree once per page and every node is one or a few
tensor operations on the page's device.

Special forms implemented here (the reference's special BytecodeGenerators,
sql/gen/AndCodeGenerator.java etc.):
  and / or      — SQL three-valued (Kleene) logic
  not, is_null, is_not_null
  if / case     — searched CASE via nested torch.where
  coalesce, nullif
  in            — OR of equalities (dictionary fast path via functions.eq)
  between       — lo <= v AND v <= hi
  cast          — numeric/decimal/date conversions

Everything else dispatches to the scalar registry (expr/functions.py).
Higher-order (lambda) forms are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..page import Block, Page, intern_dictionary, to_tensor
from . import datetime_kernels as dt
from .functions import NotPortedError, Val, and_valid, apply_function
from .ir import Call, ColumnRef, Lambda, Literal, RowExpression

LAMBDA_FORMS = {
    "transform",
    "filter",
    "reduce",
    "zip_with",
    "map_zip_with",
    "any_match",
    "all_match",
    "none_match",
    "map_filter",
    "transform_values",
    "transform_keys",
}

SPECIAL_FORMS = {
    "and",
    "or",
    "not",
    "is_null",
    "is_not_null",
    "if",
    "case",
    "coalesce",
    "nullif",
    "in",
    "between",
    "cast",
    "try_cast",
}


def evaluate(expr: RowExpression, page: Page, n: Optional[int] = None) -> Val:
    """Evaluate `expr` against the page's blocks. Returns a capacity-length Val."""
    cap = page.capacity

    if isinstance(expr, ColumnRef):
        blk = page.block(expr.name)
        if blk.key_block is not None:
            raise NotPortedError("not ported yet: map-typed columns")
        return Val(
            blk.data, blk.valid, blk.type, blk.dict_id,
            lengths=blk.lengths, elem_valid=blk.elem_valid,
        )

    if isinstance(expr, Literal):
        return _literal_val(expr, cap, page.device)

    if isinstance(expr, Lambda):
        raise TypeError(
            f"bare Lambda {expr} outside a lambda-form call — planner bug"
        )

    assert isinstance(expr, Call), expr
    name = expr.name

    if name in LAMBDA_FORMS:
        raise NotPortedError(f"not ported yet: lambda form {name!r}")

    if name == "and":
        return _kleene_and([evaluate(a, page) for a in expr.args])
    if name == "or":
        return _kleene_or([evaluate(a, page) for a in expr.args])
    if name == "not":
        v = evaluate(expr.args[0], page)
        return Val(~v.data, v.valid, T.BOOLEAN)
    if name == "is_null":
        v = evaluate(expr.args[0], page)
        data = (
            torch.zeros(cap, dtype=torch.bool, device=page.device)
            if v.valid is None else ~v.valid
        )
        return Val(data, None, T.BOOLEAN)
    if name == "is_not_null":
        v = evaluate(expr.args[0], page)
        data = (
            torch.ones(cap, dtype=torch.bool, device=page.device)
            if v.valid is None else v.valid
        )
        return Val(data, None, T.BOOLEAN)
    if name == "if":
        cond, then, els = (evaluate(a, page) for a in expr.args)
        return _if_val(cond, then, els, expr.type)
    if name == "case":
        # args = [cond1, val1, cond2, val2, ..., else]
        args = [evaluate(a, page) for a in expr.args]
        *pairs, els = args
        out = els
        for i in range(len(pairs) - 2, -1, -2):
            out = _if_val(pairs[i], pairs[i + 1], out, expr.type)
        return out
    if name == "coalesce":
        vals = [evaluate(a, page) for a in expr.args]
        out = vals[-1]
        for v in vals[-2::-1]:
            out = _if_val(Val(v.valid_mask(), None, T.BOOLEAN), v, out, expr.type)
        return out
    if name == "nullif":
        a, b = (evaluate(x, page) for x in expr.args)
        eq = apply_function("eq", [a, b], T.BOOLEAN)
        new_valid = and_valid(a.valid, ~(eq.data & eq.valid_mask()))
        return Val(a.data, new_valid, expr.type, a.dict_id)
    if name == "in":
        v = evaluate(expr.args[0], page)
        hits = [
            apply_function("eq", [v, evaluate(o, page)], T.BOOLEAN)
            for o in expr.args[1:]
        ]
        return _kleene_or(hits)
    if name == "between":
        v, lo, hi = (evaluate(a, page) for a in expr.args)
        ge = apply_function("ge", [v, lo], T.BOOLEAN)
        le = apply_function("le", [v, hi], T.BOOLEAN)
        return _kleene_and([ge, le])
    if name == "cast":
        return _cast_val(evaluate(expr.args[0], page), expr.type)
    if name == "try_cast":
        return _cast_val(evaluate(expr.args[0], page), expr.type, null_on_failure=True)

    vals = [evaluate(a, page) for a in expr.args]
    out = apply_function(name, vals, expr.type)
    if out.data.ndim == 0:
        # a zero-argument function (pi(), now(), ...): one value for every row
        data = torch.full((cap,), out.data.item(), dtype=out.data.dtype, device=page.device)
        out = Val(data, out.valid, out.type, out.dict_id, literal=out.literal)
    return out


# ---------------------------------------------------------------------------


def _literal_val(expr: Literal, cap: int, device) -> Val:
    t = expr.type
    if expr.value is None:
        return Val(
            torch.zeros(cap, dtype=t.storage_dtype, device=device),
            torch.zeros(cap, dtype=torch.bool, device=device),
            t,
        )
    if isinstance(t, T.VarcharType):
        did = intern_dictionary((expr.value,))
        return Val(
            torch.zeros(cap, dtype=torch.int32, device=device), None, t, did,
            literal=expr.value,
        )
    if isinstance(t, T.DateType) and isinstance(expr.value, str):
        days = dt.parse_date_literal(expr.value)
        return Val(
            torch.full((cap,), days, dtype=torch.int32, device=device), None, t,
            literal=days,
        )
    if isinstance(t, T.DecimalType):
        from decimal import Decimal

        scaled = int((Decimal(str(expr.value)) * (10**t.scale)).to_integral_value())
        if t.is_long:
            if abs(scaled) >= (1 << 95):
                raise ValueError(
                    f"decimal literal {expr.value} exceeds the two-lane "
                    "range (~2^95)"
                )
            lanes = torch.tensor(
                [[scaled >> 32, scaled & 0xFFFFFFFF]], dtype=torch.int64, device=device
            )
            return Val(lanes.expand(cap, 2), None, t, literal=expr.value)
        return Val(
            torch.full((cap,), scaled, dtype=torch.int64, device=device), None, t,
            literal=expr.value,
        )
    return Val(
        torch.full((cap,), expr.value, dtype=t.storage_dtype, device=device), None, t,
        literal=expr.value,
    )


def _kleene_and(vals: Sequence[Val]) -> Val:
    data, valid = vals[0].data, vals[0].valid
    for v in vals[1:]:
        new_data = data & v.data
        if valid is None and v.valid is None:
            valid = None
        else:
            av = torch.ones_like(data) if valid is None else valid
            bv = v.valid_mask()
            # result valid if: both valid, or either side is a valid FALSE
            valid = (av & bv) | (av & ~data) | (bv & ~v.data)
        data = new_data
    return Val(data, valid, T.BOOLEAN)


def _kleene_or(vals: Sequence[Val]) -> Val:
    data, valid = vals[0].data, vals[0].valid
    for v in vals[1:]:
        new_data = data | v.data
        if valid is None and v.valid is None:
            valid = None
        else:
            av = torch.ones_like(data) if valid is None else valid
            bv = v.valid_mask()
            # result valid if: both valid, or either side is a valid TRUE
            valid = (av & bv) | (av & data) | (bv & v.data)
        data = new_data
    return Val(data, valid, T.BOOLEAN)


def _if_val(cond: Val, then: Val, els: Val, out_type: T.Type) -> Val:
    c = cond.data & cond.valid_mask()
    a, b = _align_pair(then, els, out_type)  # same dict_id after alignment
    da, db = a.data, b.data
    if da.ndim != db.ndim:
        # one branch is long-decimal lanes, the other a scalar column
        from ..ops import decimal128 as d128

        if da.ndim == 1:
            da = d128.from_int64(da.to(torch.int64))
        else:
            db = d128.from_int64(db.to(torch.int64))
    cw = c[:, None] if da.ndim == 2 else c
    data = torch.where(cw, da, db)
    if a.valid is None and b.valid is None:
        valid = None
    else:
        valid = torch.where(c, a.valid_mask(), b.valid_mask())
    return Val(data, valid, out_type, a.dict_id)


def _align_pair(a: Val, b: Val, out_type: T.Type):
    """Bring two Vals into the same representation for torch.where."""
    if isinstance(out_type, T.VarcharType):
        if a.dict_id == b.dict_id:
            return a, b
        from .functions import unify_dictionaries

        xa, xb, did = unify_dictionaries(a, b)
        return Val(xa, a.valid, out_type, did), Val(xb, b.valid, out_type, did)
    return _cast_val(a, out_type), _cast_val(b, out_type)


def _cast_val(v: Val, to: T.Type, null_on_failure: bool = False) -> Val:
    frm = v.type
    if frm == to:
        return v
    dev = v.device
    if isinstance(frm, T.UnknownType):
        return Val(
            torch.zeros(v.data.shape, dtype=to.storage_dtype, device=dev),
            torch.zeros(v.data.shape, dtype=torch.bool, device=dev),
            to,
        )
    if isinstance(frm, T.VarcharType) and not isinstance(to, (T.VarcharType, T.DateType)):
        return _cast_varchar_entries(v, to, null_on_failure)
    if isinstance(to, T.VarcharType):
        if isinstance(frm, T.VarcharType):
            return Val(v.data, v.valid, to, v.dict_id)
        raise NotImplementedError(f"cast {frm} -> varchar")
    frm_long = isinstance(frm, T.DecimalType) and frm.is_long
    if isinstance(to, (T.DoubleType, T.RealType)):
        s = frm.scale if isinstance(frm, T.DecimalType) else 0
        if frm_long:
            from ..ops import decimal128 as d128

            d = d128.to_float64(v.data).to(to.storage_dtype)
        else:
            d = v.data.to(to.storage_dtype)
        return Val(d / (10**s) if s else d, v.valid, to)
    if isinstance(to, T.DecimalType):
        from .functions import _rescale, _round_half_away, _to_lanes

        if to.is_long:
            from ..ops import decimal128 as d128

            if T.is_floating(frm):
                d = _round_half_away(v.data * (10**to.scale)).to(torch.int64)
                return Val(d128.from_int64(d), v.valid, to)
            return Val(_to_lanes(v, to.scale), v.valid, to)
        if frm_long:
            from ..ops import decimal128 as d128

            lanes = d128.rescale(v.data, to.scale - frm.scale)
            return Val(d128.to_int64(lanes), v.valid, to)
        if isinstance(frm, T.DecimalType):
            return Val(
                _rescale(v.data.to(torch.int64), frm.scale, to.scale), v.valid, to
            )
        if T.is_floating(frm):
            d = _round_half_away(v.data * (10**to.scale)).to(torch.int64)
            return Val(d, v.valid, to)
        return Val(v.data.to(torch.int64) * (10**to.scale), v.valid, to)
    if T.is_integral(to):
        from .functions import _rescale, _round_half_away

        if frm_long:
            from ..ops import decimal128 as d128

            lanes = d128.rescale(v.data, -frm.scale)
            return Val(d128.to_int64(lanes).to(to.storage_dtype), v.valid, to)
        if isinstance(frm, T.DecimalType):
            d = _rescale(v.data.to(torch.int64), frm.scale, 0)
            return Val(d.to(to.storage_dtype), v.valid, to)
        if T.is_floating(frm):
            return Val(_round_half_away(v.data).to(to.storage_dtype), v.valid, to)
        return Val(v.data.to(to.storage_dtype), v.valid, to)
    if isinstance(to, T.BooleanType):
        return Val(v.data != 0, v.valid, to)
    if isinstance(to, T.DateType) and isinstance(frm, T.VarcharType):
        d = v.dictionary or ()
        table = to_tensor(
            np.array([dt.parse_date_literal(s) for s in d], np.int32), torch.int32, dev
        )
        return Val(table[v.data.to(torch.int64)], v.valid, to)
    raise NotImplementedError(f"cast {frm} -> {to}")


def _cast_varchar_entries(v: Val, to: T.Type, null_on_failure: bool) -> Val:
    """varchar -> numeric/boolean: parse once per DICTIONARY entry on the
    host. CAST raises on any unparseable entry; TRY_CAST maps it to NULL."""
    import decimal as _dec

    d = v.dictionary or ()

    def parse(s: str):
        s2 = s.strip()
        try:
            if isinstance(to, T.BooleanType):
                low = s2.lower()
                if low in ("true", "t", "1"):
                    return 1, True
                if low in ("false", "f", "0"):
                    return 0, True
                return 0, False
            if T.is_integral(to):
                return int(s2), True
            if T.is_floating(to):
                return float(s2), True
            if isinstance(to, T.DecimalType):
                q = _dec.Decimal(s2).scaleb(to.scale).to_integral_value(
                    rounding=_dec.ROUND_HALF_UP
                )
                x = int(q)
                if to.is_long and abs(x) >= (1 << 95):
                    return 0, False
                if not to.is_long and abs(x) >= (1 << 63):
                    return 0, False
                return x, True
        except (ValueError, _dec.InvalidOperation, ArithmeticError):
            return 0, False
        return 0, False

    parsed = [parse(s) for s in d]
    bad = [s for s, (_, ok) in zip(d, parsed) if not ok]
    if bad and not null_on_failure:
        raise ValueError(
            f"Cannot cast {bad[0]!r} to {to.display()} (CAST; use "
            "TRY_CAST for NULL-on-failure)"
        )
    idx = v.data.to(torch.int64)
    if isinstance(to, T.DecimalType) and to.is_long:
        lanes = np.zeros((max(len(parsed), 1), 2), np.int64)
        for i, (x, _ok) in enumerate(parsed):
            lanes[i, 0] = x >> 32
            lanes[i, 1] = x & 0xFFFFFFFF
        data = to_tensor(lanes, torch.int64, v.device)[idx]
    else:
        if isinstance(to, T.BooleanType):
            npdt = np.bool_
        elif T.is_floating(to):
            npdt = np.float64 if isinstance(to, T.DoubleType) else np.float32
        else:
            npdt = np.int64
        table = np.array([x for x, _ in parsed] or [0], npdt)
        data = to_tensor(table, to.storage_dtype, v.device)[idx]
    okt = to_tensor(np.array([ok for _, ok in parsed] or [True], bool), torch.bool, v.device)
    ok = okt[idx]
    valid = ok if v.valid is None else (v.valid & ok)
    if not bad:
        valid = v.valid  # all entries parse: keep original nullability
    return Val(data, valid, to)


# ---------------------------------------------------------------------------
# page-level entry point (the PageProcessor analog,
# reference operator/project/PageProcessor.java)
# ---------------------------------------------------------------------------


def project_page(
    page: Page, exprs: Sequence[RowExpression], names: Sequence[str]
) -> Page:
    """Evaluate projections; returns a new page with the same live count."""
    blocks = []
    for e in exprs:
        v = evaluate(e, page)
        if v.keys is not None:
            raise NotPortedError("not ported yet: map-typed projections")
        blocks.append(
            Block(
                v.data, v.type, v.valid, v.dict_id,
                lengths=v.lengths, elem_valid=v.elem_valid,
            )
        )
    return Page(tuple(blocks), tuple(names), page.count)
