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
Higher-order (lambda) forms evaluate their body as an ordinary scalar
expression over the flattened elements (`_eval_lambda_form`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..page import Block, Page, intern_dictionary, to_tensor
from . import datetime_kernels as dt
from .functions import (
    Val, and_valid, apply_function, array_in_bounds, array_lengths, lane_compaction,
)
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
        keys_val = None
        if blk.key_block is not None:
            kb = blk.key_block
            keys_val = Val(
                kb.data, None, T.ArrayType(blk.type.key), kb.dict_id,
                lengths=kb.lengths, elem_valid=kb.elem_valid,
            )
        return Val(
            blk.data, blk.valid, blk.type, blk.dict_id,
            lengths=blk.lengths, elem_valid=blk.elem_valid, keys=keys_val,
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
        return _eval_lambda_form(expr, page)

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
        kb = None
        if v.keys is not None:
            k = v.keys
            kb = Block(
                k.data, v.type.key, None, k.dict_id,
                lengths=k.lengths, elem_valid=k.elem_valid,
            )
        blocks.append(
            Block(
                v.data, v.type, v.valid, v.dict_id,
                lengths=v.lengths, elem_valid=v.elem_valid, key_block=kb,
            )
        )
    return Page(tuple(blocks), tuple(names), page.count)


# ---------------------------------------------------------------------------
# higher-order (lambda) functions over arrays and maps
# ---------------------------------------------------------------------------
# Strategy (reference ArrayTransformFunction & friends): flatten the
# (capacity, width) element matrix to one (capacity * width) column, append
# every outer column row-repeated `width` times, and evaluate the lambda
# BODY as an ordinary scalar expression over that flat page — every scalar
# function is reused unchanged. Results reshape back to (capacity, width).


def _column_names(expr, out: set) -> set:
    """Names of the columns an expression reads."""
    if isinstance(expr, ColumnRef):
        out.add(expr.name)
    elif isinstance(expr, Call):
        for a in expr.args:
            _column_names(a, out)
    elif isinstance(expr, Lambda):
        _column_names(expr.body, out)
    return out


def _flat_page_for(page: Page, width: int, params, body) -> Page:
    """The outer columns `body` reads, row-repeated `width` times, plus the
    lambda-param blocks. Columns the body does not read are left out: an
    outer array column repeated `width` times would be width^2 per row."""
    blocks, names = [], []
    used = _column_names(body, set()) - {nm for nm, _ in params}
    for nm, b in zip(page.names, page.blocks):
        if nm not in used:
            continue
        if width == 1:
            blocks.append(b)
        else:
            blocks.append(b.take_rows(
                torch.arange(b.capacity, device=b.device).repeat_interleave(width)))
        names.append(nm)
    for nm, v in params:
        blocks.append(Block(v.data, v.type, v.valid, v.dict_id,
                            lengths=v.lengths, elem_valid=v.elem_valid))
        names.append(nm)
    cap = page.capacity * width
    return Page(tuple(blocks), tuple(names),
                torch.tensor(cap, dtype=torch.int32, device=page.device))


def _elements_val(arr: Val, elem_t: T.Type) -> Val:
    """Flatten an array Val's elements to a (capacity*width,) Val."""
    width = arr.data.shape[1]
    data = arr.data.reshape((arr.data.shape[0] * width,) + tuple(arr.data.shape[2:]))
    valid = None if arr.elem_valid is None else arr.elem_valid.reshape(-1)
    return Val(data, valid, elem_t, arr.dict_id)


def _take_lanes(x: Optional[torch.Tensor], order: torch.Tensor):
    if x is None:
        return None
    idx = order.reshape(tuple(order.shape) + (1,) * (x.ndim - 2)).expand(
        tuple(order.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def _eval_lambda_form(expr: Call, page: Page) -> Val:
    name = expr.name
    out_type = expr.type
    if name == "zip_with":
        return _eval_zip_with(expr, page)
    if name == "map_zip_with":
        return _eval_map_zip_with(expr, page)
    if name == "reduce":
        return _eval_reduce(expr, page)
    if name in ("map_filter", "transform_values", "transform_keys"):
        return _eval_map_lambda(expr, page)
    arr = evaluate(expr.args[0], page)
    lam: Lambda = expr.args[1]
    if arr.data.ndim != 2:
        raise TypeError(f"{name} expects an array value")
    cap, width = arr.data.shape[0], arr.data.shape[1]
    elems = _elements_val(arr, lam.param_types[0])
    flat = _flat_page_for(page, width, [(lam.params[0], elems)], lam.body)
    body = evaluate(lam.body, flat)
    inb = array_in_bounds(arr)

    if name == "transform":
        data = body.data.reshape((cap, width) + tuple(body.data.shape[1:]))
        evalid = None if body.valid is None else body.valid.reshape(cap, width)
        return Val(data, arr.valid, out_type, body.dict_id,
                   lengths=array_lengths(arr), elem_valid=evalid)
    if name == "filter":
        keep = (body.data & body.valid_mask()).reshape(cap, width) & inb
        order = lane_compaction(keep)
        lengths = keep.sum(dim=1, dtype=torch.int32)
        return Val(_take_lanes(arr.data, order), arr.valid, out_type, arr.dict_id,
                   lengths=lengths, elem_valid=_take_lanes(arr.elem_valid, order))
    # any/all/none_match over in-bounds elements: the two-valued reduction
    # of the JAX package (a NULL lambda result counts as false)
    truthy = (body.data & body.valid_mask()).reshape(cap, width)
    if name == "any_match":
        agg = (truthy & inb).any(dim=1)
    elif name == "all_match":
        agg = (truthy | ~inb).all(dim=1)
    else:  # none_match
        agg = ~(truthy & inb).any(dim=1)
    return Val(agg, arr.valid, T.BOOLEAN)


def _unify_key_lanes(k1: Val, k2: Val):
    """Two key lanes in one representation: varchar dictionaries unified,
    numeric dtypes promoted."""
    kd1, kd2, kdict = k1.data, k2.data, k1.dict_id
    if (k1.dict_id is not None or k2.dict_id is not None) and k1.dict_id != k2.dict_id:
        from .functions import unify_dictionaries

        kd1, kd2, kdict = unify_dictionaries(k1, k2)
    if kd1.dtype != kd2.dtype:
        wide = torch.promote_types(kd1.dtype, kd2.dtype)
        kd1, kd2 = kd1.to(wide), kd2.to(wide)
    return kd1, kd2, kdict


def _eval_map_zip_with(expr: Call, page: Page) -> Val:
    """map_zip_with(m1, m2, (k, v1, v2) -> ...) — reference
    MapZipWithFunction: output keys are the UNION of the two key sets; a
    side's value is NULL where its map lacks the key. One per-row sort
    over (out_of_bounds, key) clusters duplicates, a shifted compare marks
    first occurrences, and each side's value is a masked equality lookup
    of the union keys in that side's key lane."""
    m1 = evaluate(expr.args[0], page)
    m2 = evaluate(expr.args[1], page)
    lam: Lambda = expr.args[2]
    if m1.keys is None or m2.keys is None:
        raise TypeError("map_zip_with expects two map values")
    kd1, kd2, kdict = _unify_key_lanes(m1.keys, m2.keys)
    cap = m1.data.shape[0]
    W = m1.data.shape[1] + m2.data.shape[1]
    inb1, inb2 = array_in_bounds(m1), array_in_bounds(m2)
    allk = torch.cat([kd1, kd2], dim=1)
    inb = torch.cat([inb1, inb2], dim=1)
    # sort by key, then stably by the out-of-bounds flag: in-bounds lanes
    # first, equal keys adjacent, padding never mistaken for a real key
    o = torch.argsort(allk, dim=1, stable=True)
    o = torch.gather(o, 1, torch.argsort(torch.gather((~inb).to(torch.uint8), 1, o),
                                         dim=1, stable=True))
    sk = torch.gather(allk, 1, o)
    sinb = torch.gather(inb, 1, o)
    first = torch.cat([torch.ones((cap, 1), dtype=torch.bool, device=sk.device),
                       sk[:, 1:] != sk[:, :-1]], dim=1)
    uniq = sinb & first
    ukeys = torch.gather(sk, 1, lane_compaction(uniq))
    ulen = uniq.sum(dim=1, dtype=torch.int32)

    def lookup(m: Val, kd, inbm):
        eq = (ukeys[:, :, None] == kd[:, None, :]) & inbm[:, None, :]
        found = eq.any(dim=2)
        idx = eq.to(torch.uint8).argmax(dim=2)
        vdat = torch.gather(m.data, 1, idx)
        ev = found
        if m.elem_valid is not None:
            ev = ev & torch.gather(m.elem_valid, 1, idx)
        return vdat, ev

    v1, ev1 = lookup(m1, kd1, inb1)
    v2, ev2 = lookup(m2, kd2, inb2)
    flat = _flat_page_for(page, W, [
        (lam.params[0], Val(ukeys.reshape(-1), None, lam.param_types[0], kdict)),
        (lam.params[1], Val(v1.reshape(-1), ev1.reshape(-1), lam.param_types[1],
                            m1.dict_id)),
        (lam.params[2], Val(v2.reshape(-1), ev2.reshape(-1), lam.param_types[2],
                            m2.dict_id)),
    ], lam.body)
    body = evaluate(lam.body, flat)
    bvalid = None if body.valid is None else body.valid.reshape(cap, W)
    new_keys = Val(ukeys, None, expr.type.key, kdict, lengths=ulen)
    return Val(body.data.reshape(cap, W), and_valid(m1.valid, m2.valid), expr.type,
               body.dict_id, lengths=ulen, elem_valid=bvalid, keys=new_keys)


def _eval_map_lambda(expr: Call, page: Page) -> Val:
    """map_filter / transform_values / transform_keys: the lambda body
    evaluates over flattened (key, value) element pairs (reference
    MapFilterFunction + MapTransform*Function)."""
    name = expr.name
    out_type = expr.type
    m = evaluate(expr.args[0], page)
    lam: Lambda = expr.args[1]
    if m.keys is None or m.data.ndim != 2:
        raise TypeError(f"{name} expects a map value")
    keys = m.keys
    cap, width = m.data.shape[0], m.data.shape[1]
    flat = _flat_page_for(page, width, [
        (lam.params[0], _elements_val(keys, lam.param_types[0])),
        (lam.params[1], _elements_val(m, lam.param_types[1])),
    ], lam.body)
    body = evaluate(lam.body, flat)
    inb = array_in_bounds(m)

    if name == "map_filter":
        keep = (body.data & body.valid_mask()).reshape(cap, width) & inb
        order = lane_compaction(keep)
        lengths = keep.sum(dim=1, dtype=torch.int32)
        new_keys = Val(torch.gather(keys.data, 1, order), None, keys.type, keys.dict_id,
                       lengths=lengths)
        return Val(torch.gather(m.data, 1, order), m.valid, out_type, m.dict_id,
                   lengths=lengths, elem_valid=_take_lanes(m.elem_valid, order),
                   keys=new_keys)
    bdata = body.data.reshape(cap, width)
    bvalid = None if body.valid is None else body.valid.reshape(cap, width)
    if name == "transform_values":
        # the body's OWN validity is the only per-entry nullability (it
        # already folds in elem_valid when the body reads v)
        return Val(bdata, m.valid, out_type, body.dict_id, lengths=m.lengths,
                   elem_valid=bvalid, keys=keys)
    # transform_keys: values unchanged; keys replaced by the body
    new_keys = Val(bdata, None, out_type.key, body.dict_id, lengths=m.lengths)
    return Val(m.data, m.valid, out_type, m.dict_id, lengths=m.lengths,
               elem_valid=m.elem_valid, keys=new_keys)


def _eval_zip_with(expr: Call, page: Page) -> Val:
    a = evaluate(expr.args[0], page)
    b = evaluate(expr.args[1], page)
    lam: Lambda = expr.args[2]
    cap = a.data.shape[0]
    width = max(a.data.shape[1], b.data.shape[1])
    lane = torch.arange(width, dtype=torch.int32, device=a.device)[None, :]

    def elems(v: Val, pt):
        # the shorter array's missing elements are NULL (Presto zip_with)
        pad = width - v.data.shape[1]
        data = v.data
        ev = v.elem_valid
        if ev is None:
            ev = torch.ones(v.data.shape[:2], dtype=torch.bool, device=v.device)
        if pad:
            data = torch.cat([data, torch.zeros((cap, pad) + tuple(data.shape[2:]),
                                                dtype=data.dtype, device=data.device)], 1)
            ev = torch.cat([ev, torch.zeros((cap, pad), dtype=torch.bool,
                                            device=ev.device)], 1)
        ln = array_lengths(v)
        ev = ev & (lane < ln[:, None])
        return Val(data.reshape((cap * width,) + tuple(data.shape[2:])), ev.reshape(-1),
                   pt, v.dict_id), ln

    ea, la = elems(a, lam.param_types[0])
    eb, lb = elems(b, lam.param_types[1])
    flat = _flat_page_for(page, width, [(lam.params[0], ea), (lam.params[1], eb)],
                          lam.body)
    body = evaluate(lam.body, flat)
    data = body.data.reshape((cap, width) + tuple(body.data.shape[1:]))
    evalid = None if body.valid is None else body.valid.reshape(cap, width)
    return Val(data, and_valid(a.valid, b.valid), expr.type, body.dict_id,
               lengths=torch.maximum(la, lb), elem_valid=evalid)


def _eval_reduce(expr: Call, page: Page) -> Val:
    """reduce(array, init, (s, x) -> s', s -> r): the state folds over the
    array's width, one lane per step, masked past each row's length."""
    arr = evaluate(expr.args[0], page)
    init = evaluate(expr.args[1], page)
    input_fn: Lambda = expr.args[2]
    output_fn: Lambda = expr.args[3]
    width = arr.data.shape[1]
    inb = array_in_bounds(arr)
    state = init
    if state.type != input_fn.param_types[0]:
        state = _cast_val(state, input_fn.param_types[0])
    for j in range(width):
        evalid = None if arr.elem_valid is None else arr.elem_valid[:, j]
        ev = Val(arr.data[:, j], evalid, input_fn.param_types[1], arr.dict_id)
        flat = _flat_page_for(page, 1, [(input_fn.params[0], state),
                                        (input_fn.params[1], ev)], input_fn.body)
        nxt = evaluate(input_fn.body, flat)
        live = inb[:, j]
        ndata, sdata = nxt.data, state.data
        if ndata.dtype != sdata.dtype:
            sdata = sdata.to(ndata.dtype)
        data = torch.where(live.reshape((-1,) + (1,) * (ndata.ndim - 1)), ndata, sdata)
        if state.valid is None and nxt.valid is None:
            valid = None
        else:
            valid = torch.where(live, nxt.valid_mask(), state.valid_mask())
        state = Val(data, valid, nxt.type, nxt.dict_id)
    flat = _flat_page_for(page, 1, [(output_fn.params[0], state)], output_fn.body)
    out = evaluate(output_fn.body, flat)
    return Val(out.data, and_valid(out.valid, arr.valid), expr.type, out.dict_id)
