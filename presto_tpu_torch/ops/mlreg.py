"""ML-in-SQL: linear regression as a mergeable aggregate (torch counterpart
of presto_tpu/ops/mlreg.py).

Re-designed equivalent of presto-ml (learn_regressor / learn_classifier
aggregates + regress/classify scalars over libsvm models). The MODEL is an
ARRAY(DOUBLE) [w_0..w_{K_MAX-1}, intercept, label_min, label_max]; the
trailing label bounds let classify() clamp to the trained label range
(user-written literal models keep the intercept-last contract and carry no
bounds). LEARNING is the normal-equations accumulation, a segment sum:

    acc(group) = [ n | X^T y | vec(X^T X) | label_min | label_max ]
    with X = [features, 1]

Accumulators use a canonical width (K_MAX features) whatever the array's
width, so partials align lane for lane and merge by addition (min/max for
the bounds). Unused feature lanes contribute zeros; the ridge term keeps the
per-group (K_MAX+1)^2 solve nonsingular, so absent features learn ~0
weights. `predict` reads the intercept at the model's last LIVE lane.
"""

from __future__ import annotations

import torch

K_MAX = 15  # max feature lanes; canonical accumulator layout
_M = K_MAX + 1  # + intercept
_SUM_WIDTH = 1 + _M + _M * _M  # additively merged lanes
ACC_WIDTH = _SUM_WIDTH + 2  # + label min, label max
MODEL_WIDTH = _M + 2  # [w..., intercept, label_min, label_max]
_RIDGE = 1e-9


def logical_values(data: torch.Tensor, typ) -> torch.Tensor:
    """Array/scalar decimal storage -> logical float64 (regression inputs
    may be decimal-scaled ints). Shared by learn and regress."""
    d = data.to(torch.float64)
    et = getattr(typ, "element", typ)
    scale = getattr(et, "scale", None)
    return d / (10**scale) if scale else d


# rows per chunk of the accumulation: the (rows, 273) float64 outer-product
# block of one chunk is ~140 MB, not 13 GB for TPC-H SF 1's lineitem
CHUNK_ROWS = 1 << 16


SUB_ROWS = 256  # rows per sub-run of the two-level segmented reduction


def _segment(x, gid, num_groups: int, reduce: str):
    """Per-group reduction of rows whose group ids are SORTED
    (non-decreasing). Two levels, with no long serial loop and no atomics
    piling onto a few addresses when there are few groups: a segmented
    reduction over sub-runs of at most SUB_ROWS rows of one group, then the
    sub-run results folded into their groups."""
    n = x.shape[0]
    dev = x.device
    initial = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[reduce]
    out = torch.full((num_groups + 1,) + tuple(x.shape[1:]), initial, dtype=x.dtype,
                     device=dev)
    if n == 0:
        return out[:num_groups]
    gid = gid.to(torch.int64)
    pos = torch.arange(n, device=dev)
    start = torch.searchsorted(gid, torch.arange(num_groups, device=dev))
    sub = torch.cumsum(((pos - start[gid]) % SUB_ROWS == 0).to(torch.int64), 0) - 1
    runs = n // SUB_ROWS + num_groups + 1  # at least the number of sub-runs
    lengths = torch.zeros(runs, dtype=torch.int64, device=dev)
    lengths.index_add_(0, sub, torch.ones_like(sub))
    part = torch.segment_reduce(x, reduce, lengths=lengths, axis=0, initial=initial)
    run_gid = torch.full((runs,), num_groups, dtype=torch.int64, device=dev)
    run_gid = run_gid.scatter(0, sub, gid)  # unused runs fold into the extra row
    if reduce == "sum":
        out.index_add_(0, run_gid, part)
    else:
        out.scatter_reduce_(0, run_gid, part, "amin" if reduce == "min" else "amax",
                            include_self=True)
    return out[:num_groups]


def _chunked(fn, n: int, num_groups: int, width: int, device):
    """Sum over row chunks of fn(lo, hi) -> (num_groups, width) partials."""
    out = torch.zeros((num_groups, width), dtype=torch.float64, device=device)
    for lo in range(0, n, CHUNK_ROWS):
        out += fn(lo, min(n, lo + CHUNK_ROWS))
    return out


def _bounds(label_min, label_max, contributes, gid, num_groups: int):
    lmin = _segment(torch.where(contributes, label_min, float("inf")), gid, num_groups, "min")
    lmax = _segment(torch.where(contributes, label_max, float("-inf")), gid, num_groups, "max")
    return lmin[:, None], lmax[:, None]


def group_accumulate(features, lengths, label, contributes, gid, num_groups: int):
    """Per-group flat normal-equation accumulators (num_groups, ACC_WIDTH)
    from (n, k) float64 features with per-row lengths and (n,) labels;
    `gid` sorted."""
    n, k = features.shape
    if k > K_MAX:
        raise ValueError(
            f"learn_linear_regression supports up to {K_MAX} features, got {k}")
    dev = features.device

    def part(lo, hi):
        m = hi - lo
        x = torch.zeros((m, _M), dtype=torch.float64, device=dev)
        lane_ok = torch.arange(k, device=dev)[None, :] < lengths[lo:hi, None]
        x[:, :k] = torch.where(lane_ok, features[lo:hi], 0.0)
        x[:, K_MAX] = 1.0
        # mask EXCLUDED rows with where: a 0-weight multiply would let
        # their NaN/Inf storage poison the group
        c = contributes[lo:hi]
        x = torch.where(c[:, None], x, 0.0)
        y = torch.where(c, label[lo:hi], 0.0)
        xtx = (x[:, :, None] * x[:, None, :]).reshape(m, _M * _M)
        flat = torch.cat([c.to(torch.float64)[:, None], x * y[:, None], xtx], dim=1)
        return _segment(flat, gid[lo:hi], num_groups, "sum")

    sums = _chunked(part, n, num_groups, _SUM_WIDTH, dev)
    return torch.cat([sums, *_bounds(label, label, contributes, gid, num_groups)], dim=1)


def merge_accumulators(accs, contributes, gid, num_groups: int):
    """Merge partial accumulator rows per group (sums add, bounds min/max);
    `gid` sorted."""
    rows = torch.where(contributes[:, None], accs[:, :_SUM_WIDTH], 0.0)
    sums = _segment(rows, gid, num_groups, "sum")
    if accs.shape[1] >= ACC_WIDTH:
        lmin_in, lmax_in = accs[:, _SUM_WIDTH], accs[:, _SUM_WIDTH + 1]
    else:  # partials without bound lanes
        lmin_in = lmax_in = torch.zeros(accs.shape[0], dtype=accs.dtype, device=accs.device)
    return torch.cat([sums, *_bounds(lmin_in, lmax_in, contributes, gid, num_groups)], dim=1)


def solve_weights(accs):
    """(G, ACC_WIDTH) accumulators -> ((G, MODEL_WIDTH) models, (G,) has-rows)."""
    g = accs.shape[0]
    counts = accs[:, 0]
    xty = accs[:, 1:1 + _M]
    xtx = accs[:, 1 + _M:_SUM_WIDTH].reshape(g, _M, _M)
    xtx = xtx + _RIDGE * torch.eye(_M, dtype=xtx.dtype, device=xtx.device)[None]
    w = torch.linalg.solve(xtx, xty[..., None])[..., 0]
    if accs.shape[1] >= ACC_WIDTH:
        bounds = accs[:, _SUM_WIDTH:ACC_WIDTH]
    else:
        bounds = torch.zeros((g, 2), dtype=accs.dtype, device=accs.device)
    return torch.cat([w, bounds], dim=1), counts > 0


def predict(features, flengths, model, mlengths):
    """regress(features, model): dot(features, w) + intercept, honoring
    BOTH sides' live lengths (the intercept is the model's last LIVE lane;
    padded lanes are never read)."""
    k = features.shape[1]
    mw = model.shape[1]
    m = model.to(torch.float64)
    f = features.to(torch.float64)
    n_weights = torch.clamp(mlengths - 1, min=0)  # lanes before the intercept
    use = torch.minimum(n_weights, torch.clamp(flengths, max=k))
    kk = min(k, mw)
    ok = torch.arange(kk, device=f.device)[None, :] < use[:, None]
    dot = torch.where(ok, f[:, :kk] * m[:, :kk], 0.0).sum(dim=1)
    icpt_idx = torch.clamp(mlengths - 1, 0, mw - 1).to(torch.int64)
    intercept = torch.gather(m, 1, icpt_idx[:, None])[:, 0]
    return dot + intercept
