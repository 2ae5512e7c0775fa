"""Mergeable central-moments accumulator for stddev/variance/skewness/
kurtosis (torch counterpart of presto_tpu/ops/moments.py).

Re-designed equivalent of the reference's CentralMomentsAggregation
(presto-main/.../operator/aggregation/AggregationUtils.java
updateCentralMomentsState): the whole batch is in device memory, so the
stable computation is two segment reductions, the group mean first and
then the centred power sums. Raw power sums cancel catastrophically for
data with a large mean ((nan, -inf) at a mean near 1e9).

Accumulator row layout (ARRAY(DOUBLE), width 5):

    [ n, mean, M2, M3, M4 ]   with Mk = sum((x - mean)^k) over the group

Partials merge by re-centring on the merged mean (Chan et al.'s pairwise
update as segment sums): with d = mean_i - mean,

    M2' = M2 + n d^2
    M3' = M3 + 3 d M2 + n d^3
    M4' = M4 + 4 d M3 + 6 d^2 M2 + n d^4

and the shifted rows then merge by addition.
"""

from __future__ import annotations

import torch

from .aggregate import _segment_sum

ACC_WIDTH = 5


def group_moments(data, contributes, gid, num_groups: int):
    """Per-group accumulator rows (num_groups, 5), stable two-pass."""
    gid = gid.to(torch.int64)
    x = data.to(torch.float64)
    n = _segment_sum(contributes.to(torch.float64), gid, num_groups)
    s = _segment_sum(torch.where(contributes, x, 0.0), gid, num_groups)
    mean = s / torch.clamp(n, min=1.0)
    d = torch.where(contributes, x - mean[gid], 0.0)
    d2 = d * d
    m2 = _segment_sum(d2, gid, num_groups)
    m3 = _segment_sum(d2 * d, gid, num_groups)
    m4 = _segment_sum(d2 * d2, gid, num_groups)
    return torch.stack([n, mean, m2, m3, m4], dim=1)


def merge_moments(rows, contributes, gid, num_groups: int):
    """Merge accumulator rows per group by re-centring on the merged mean,
    then summing the shifted centred sums."""
    gid = gid.to(torch.int64)
    n_i = torch.where(contributes, rows[:, 0], 0.0)
    mean_i = rows[:, 1]
    m2_i = torch.where(contributes, rows[:, 2], 0.0)
    m3_i = torch.where(contributes, rows[:, 3], 0.0)
    m4_i = torch.where(contributes, rows[:, 4], 0.0)
    n = _segment_sum(n_i, gid, num_groups)
    s = _segment_sum(n_i * mean_i, gid, num_groups)
    mean = s / torch.clamp(n, min=1.0)
    d = torch.where(contributes, mean_i - mean[gid], 0.0)
    d2 = d * d
    m2 = _segment_sum(m2_i + n_i * d2, gid, num_groups)
    m3 = _segment_sum(m3_i + 3.0 * d * m2_i + n_i * d2 * d, gid, num_groups)
    m4 = _segment_sum(m4_i + 4.0 * d * m3_i + 6.0 * d2 * m2_i + n_i * d2 * d2,
                      gid, num_groups)
    return torch.stack([n, mean, m2, m3, m4], dim=1)
