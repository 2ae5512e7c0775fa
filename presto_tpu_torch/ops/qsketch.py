"""Mergeable quantile sketch, a log-scale histogram (torch counterpart of
presto_tpu/ops/qsketch.py).

The role of the reference's qdigest behind qdigest_agg and the mergeable
approx_percentile (presto-main/.../operator/aggregation/
ApproximateLongPercentileAggregations.java): per group, B int64 bin
counts where bin = (sign, floor(log2 |x|), sub-bin). Merging is an
elementwise add, building one scatter-add per row, and the value error is
relative, at most 1/(2*SUB) at the bin midpoint.

Layout (B = 3073 int64 lanes per group; _POS = (_E_MAX - _E_MIN) * SUB):
  [0]                    exact zero
  [1 .. 1536]            positives: 1 + (e - _E_MIN)*SUB + sub, e in [-32, 64)
  [1537 .. 3072]         negatives, mirrored
"""

from __future__ import annotations

import torch

SUB = 16  # sub-bins per octave; relative value error <= 1/(2*SUB)
_E_MIN = -32  # doubles below 2^-32 collapse into the smallest bin
_E_MAX = 64
_POS = (_E_MAX - _E_MIN) * SUB  # 1536
B = 1 + 2 * _POS  # 3073


def bucket_of(x):
    """Numeric values (int64 raw units or float64) -> bin index in [0, B)."""
    xf = x.to(torch.float64)
    ax = torch.abs(xf)
    safe = torch.where(ax > 0, ax, 1.0)
    e = torch.floor(torch.log2(safe)).to(torch.int64)
    e = torch.clamp(e, _E_MIN, _E_MAX - 1)
    frac = ax / torch.exp2(e.to(torch.float64))  # in [1, 2)
    sub = torch.clamp((frac - 1.0) * SUB, 0, SUB - 1).to(torch.int64)
    idx = 1 + (e - _E_MIN) * SUB + sub
    idx = torch.where(xf < 0, idx + _POS, idx)
    return torch.where(xf == 0, 0, idx)


def representative(bins):
    """Bin index -> midpoint value (float64)."""
    neg = bins > _POS
    k = torch.where(neg, bins - 1 - _POS, bins - 1)
    k = torch.clamp(k, 0, _POS - 1)
    e = torch.div(k, SUB, rounding_mode="floor").to(torch.float64) + _E_MIN
    sub = (k % SUB).to(torch.float64)
    lo = torch.exp2(e) * (1.0 + sub / SUB)
    width = torch.exp2(e) / SUB
    mid = lo + width / 2.0
    val = torch.where(neg, -mid, mid)
    return torch.where(bins == 0, 0.0, val)


def group_sketch(values, contributes, gid, num_groups: int):
    """Build per-group sketches: (num_groups, B) int64 counts."""
    flat = gid.to(torch.int64) * B + bucket_of(values)
    counts = torch.zeros(num_groups * B, dtype=torch.int64, device=values.device)
    counts.index_add_(0, flat, contributes.to(torch.int64))
    return counts.reshape(num_groups, B)


def merge_sketches(sketches, contributes, gid, num_groups: int):
    """Sum partial (n, B) sketch rows per group -> (num_groups, B)."""
    rows = sketches * contributes[:, None].to(sketches.dtype)
    out = torch.zeros((num_groups, sketches.shape[1]), dtype=sketches.dtype,
                      device=sketches.device)
    return out.index_add_(0, gid.to(torch.int64), rows)


def percentile_value(sketch, p: float):
    """(G, B) sketches -> per-group approximate percentile (float64): the
    value whose cumulative count first reaches round(p * (n - 1)) + 1, the
    exact path's nearest-rank rule."""
    totals = sketch.sum(dim=1)
    target = torch.round(p * torch.clamp(totals - 1, min=0).to(torch.float64)).to(torch.int64) + 1
    reps = representative(torch.arange(B, device=sketch.device))
    # cumulate in VALUE order (bin order is zero, positives ascending, then
    # negatives by magnitude)
    order = torch.argsort(reps, stable=True)
    cum = torch.cumsum(sketch[:, order], dim=1)
    idx = torch.argmax((cum >= target[:, None]).to(torch.int8), dim=1)
    vals = reps[order][idx]
    return torch.where(totals > 0, vals, float("nan"))
