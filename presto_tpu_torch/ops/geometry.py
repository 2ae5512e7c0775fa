"""Vectorized planar geometry — the geospatial core (torch counterpart of
presto_tpu/ops/geometry.py).

Re-designed equivalent of presto-geospatial's Esri-geometry-backed
GeoFunctions.java + presto-main's PagesRTreeIndex spatial joins: a geometry
is PADDED VERTEX LANES — an ARRAY(DOUBLE) of interleaved coordinates [x0,
y0, x1, y1, ...] with per-row vertex counts — so point-in-polygon is a
masked ray-casting reduction over the lane axis and segment intersection
broadcasts edge pairs, all tensor operations on the geometry's device. The
spatial-join accelerator is a GRID partition (KdbTree's role): points and
polygon bounding boxes are binned to the cells of a uniform grid and only
same-cell candidate pairs run the exact predicate.

WKT parsing happens on the host per DICTIONARY entry (bounded work, the
same contract as every varchar function).
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch

_WKT_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"
_PAIR_RE = re.compile(rf"({_WKT_NUM})\s+({_WKT_NUM})")


def parse_wkt(text: str) -> Tuple[str, np.ndarray]:
    """WKT -> (kind, (nv, 2) vertex array). POINT / LINESTRING / POLYGON
    (outer ring only — holes are rejected)."""
    s = text.strip()
    up = s.upper()
    if up.startswith("POINT"):
        kind = "point"
    elif up.startswith("LINESTRING"):
        kind = "linestring"
    elif up.startswith("POLYGON"):
        kind = "polygon"
        if s.count("(") > 2:
            raise ValueError("polygons with interior rings (holes) are not supported")
    else:
        raise ValueError(f"unsupported WKT geometry: {s[:30]!r}")
    pts = [(float(a), float(b)) for a, b in _PAIR_RE.findall(s)]
    if not pts:
        raise ValueError(f"no coordinates in WKT: {s[:30]!r}")
    v = np.asarray(pts, np.float64)
    if kind == "polygon" and (v[0] != v[-1]).any():
        v = np.concatenate([v, v[:1]])  # close the ring
    return kind, v


def pack_vertices(geoms: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """List of (nv, 2) arrays -> (n, maxV, 2) padded + (n,) counts."""
    n = len(geoms)
    maxv = max((g.shape[0] for g in geoms), default=1)
    out = np.zeros((n, max(maxv, 1), 2), np.float64)
    cnt = np.zeros(n, np.int32)
    for i, g in enumerate(geoms):
        out[i, : g.shape[0]] = g
        cnt[i] = g.shape[0]
    return out, cnt


def _edges(verts: torch.Tensor, nv: torch.Tensor):
    """Consecutive-vertex edge endpoints. The last live vertex points at
    ITSELF (a degenerate edge), so open paths get no phantom closing edge;
    rings are closed by parse_wkt (first vertex repeated last).
    verts (..., V, 2), nv (...,) -> (a, b, live)."""
    V = verts.shape[-2]
    idx = torch.arange(V, device=verts.device)
    nxt = torch.where(idx + 1 < nv[..., None], idx + 1, idx)
    b = torch.gather(verts, -2, nxt[..., None].expand(nxt.shape + (2,)))
    live = idx < nv[..., None]
    return verts, b, live


def is_closed_ring(verts: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """Row-wise: first vertex equals the last live vertex and >= 4 lanes."""
    li = torch.clamp(nv - 1, min=0).to(torch.int64)
    last = torch.gather(verts, -2, li[..., None, None].expand(li.shape + (1, 2)))[..., 0, :]
    return (verts[..., 0, :] == last).all(dim=-1) & (nv >= 4)


def point_in_polygon(px, py, verts, nv) -> torch.Tensor:
    """Ray-casting containment (boundary counts as inside). px/py (n,),
    verts (n, V, 2), nv (n,)."""
    a, b, live = _edges(verts, nv)
    ax, ay = a[..., 0], a[..., 1]
    bx, by = b[..., 0], b[..., 1]
    p_x, p_y = px[..., None], py[..., None]
    straddle = (ay > p_y) != (by > p_y)
    dy = by - ay
    t = torch.where(dy != 0, (p_y - ay) / torch.where(dy == 0, 1.0, dy), 0.0)
    xint = ax + t * (bx - ax)
    crossing = straddle & (p_x < xint) & live
    inside = (crossing.sum(dim=-1) % 2) == 1
    # boundary: the point on an edge segment (within eps)
    eps = 1e-12
    cross = (bx - ax) * (p_y - ay) - (by - ay) * (p_x - ax)
    dot = (p_x - ax) * (bx - ax) + (p_y - ay) * (by - ay)
    len2 = (bx - ax) ** 2 + (by - ay) ** 2
    on_edge = (
        (len2 > 1e-24)
        & (cross * cross <= eps * eps * torch.clamp(len2, min=1.0) * len2)
        & (dot >= -eps)
        & (dot <= len2 + eps)
        & live
    )
    at_vertex = (p_x == ax) & (p_y == ay) & live
    return inside | (on_edge | at_vertex).any(dim=-1)


def _orient(p, q, r):
    return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - (
        q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])


def segments_intersect(a1, a2, b1, b2) -> torch.Tensor:
    """Proper + touching segment intersection via orientation signs."""
    d1 = _orient(b1, b2, a1)
    d2 = _orient(b1, b2, a2)
    d3 = _orient(a1, a2, b1)
    d4 = _orient(a1, a2, b2)
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))

    def on_seg(p, q, r, d):
        return (
            (d == 0)
            & (r[..., 0] >= torch.minimum(p[..., 0], q[..., 0]))
            & (r[..., 0] <= torch.maximum(p[..., 0], q[..., 0]))
            & (r[..., 1] >= torch.minimum(p[..., 1], q[..., 1]))
            & (r[..., 1] <= torch.maximum(p[..., 1], q[..., 1]))
        )

    touch = (on_seg(b1, b2, a1, d1) | on_seg(b1, b2, a2, d2)
             | on_seg(a1, a2, b1, d3) | on_seg(a1, a2, b2, d4))
    return proper | touch


def segments_cross_properly(a1, a2, b1, b2) -> torch.Tensor:
    """Strict interior crossing only (no touching)."""
    d1 = _orient(b1, b2, a1)
    d2 = _orient(b1, b2, a2)
    d3 = _orient(a1, a2, b1)
    d4 = _orient(a1, a2, b2)
    return (d1 * d2 < 0) & (d3 * d4 < 0)


def contains_all_vertices(va, na, vb, nb) -> torch.Tensor:
    """Row-wise: ring A contains geometry B — every B vertex inside A and no
    PROPER edge crossing (boundary contact allowed)."""
    n, V = vb.shape[0], vb.shape[1]
    inside = point_in_polygon(
        vb[..., 0].reshape(-1), vb[..., 1].reshape(-1),
        va.repeat_interleave(V, dim=0), na.repeat_interleave(V),
    ).reshape(n, V)
    lanes = torch.arange(V, device=vb.device)[None, :] < nb[:, None]
    all_in = (inside | ~lanes).all(dim=1) & (nb > 0)
    a1, a2, la = _edges(va, na)
    b1, b2, lb = _edges(vb, nb)
    cross = segments_cross_properly(
        a1[:, :, None, :], a2[:, :, None, :], b1[:, None, :, :], b2[:, None, :, :],
    ) & la[:, :, None] & lb[:, None, :]
    return all_in & ~cross.any(dim=2).any(dim=1)


def polygons_intersect(va, na, vb, nb) -> torch.Tensor:
    """Row-wise polygon/polygon (or linestring) intersection: any edge pair
    meets, or a closed ring contains the other's first vertex."""
    a1, a2, la = _edges(va, na)
    b1, b2, lb = _edges(vb, nb)
    hit = segments_intersect(
        a1[:, :, None, :], a2[:, :, None, :], b1[:, None, :, :], b2[:, None, :, :],
    ) & la[:, :, None] & lb[:, None, :]
    edge_any = hit.any(dim=2).any(dim=1)
    a_in_b = point_in_polygon(va[:, 0, 0], va[:, 0, 1], vb, nb) & is_closed_ring(vb, nb)
    b_in_a = point_in_polygon(vb[:, 0, 0], vb[:, 0, 1], va, na) & is_closed_ring(va, na)
    return edge_any | a_in_b | b_in_a


def polygon_area(verts, nv) -> torch.Tensor:
    """Shoelace area (absolute value)."""
    a, b, live = _edges(verts, nv)
    contrib = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    return 0.5 * torch.abs(torch.where(live, contrib, 0.0).sum(dim=-1))


def polygon_centroid(verts, nv):
    """Polygon centroid (signed-area weighted); degenerate polygons fall
    back to the vertex mean."""
    a, b, live = _edges(verts, nv)
    cr = torch.where(live, a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1], 0.0)
    A2 = cr.sum(dim=-1)  # 2 * signed area
    cx = ((a[..., 0] + b[..., 0]) * cr).sum(dim=-1)
    cy = ((a[..., 1] + b[..., 1]) * cr).sum(dim=-1)
    ok = torch.abs(A2) > 1e-30
    safe = torch.where(ok, 3.0 * A2, 1.0)
    cnt = torch.clamp(nv, min=1)
    mean_x = torch.where(live, verts[..., 0], 0.0).sum(dim=-1) / cnt
    mean_y = torch.where(live, verts[..., 1], 0.0).sum(dim=-1) / cnt
    return torch.where(ok, cx / safe, mean_x), torch.where(ok, cy / safe, mean_y)


def line_length(verts, nv) -> torch.Tensor:
    """Sum of open-path segment lengths (no closing edge)."""
    V = verts.shape[-2]
    if V <= 1:
        return torch.zeros(verts.shape[0], dtype=torch.float64, device=verts.device)
    a = verts[..., :-1, :]
    b = verts[..., 1:, :]
    live = (torch.arange(V - 1, device=verts.device) + 1) < nv[..., None]
    seg = torch.sqrt(((b - a) ** 2).sum(dim=-1))
    return torch.where(live, seg, 0.0).sum(dim=-1)


def ring_perimeter(verts, nv) -> torch.Tensor:
    a, b, live = _edges(verts, nv)
    seg = torch.sqrt(((b - a) ** 2).sum(dim=-1))
    return torch.where(live, seg, 0.0).sum(dim=-1)


# ---------------------------------------------------------------------------
# grid-partitioned spatial join (reference KdbTree partitioning +
# PagesRTreeIndex probe, collapsed to a uniform grid: cells play the role
# of KDB leaves; candidate pairs are exact-tested by point_in_polygon)
# ---------------------------------------------------------------------------


def grid_spatial_join(px: np.ndarray, py: np.ndarray, polys: List[np.ndarray],
                      grid: int = 16, device="cuda") -> List[Tuple[int, int]]:
    """(point index, polygon index) pairs with the point inside the polygon.
    The grid prunes candidates on the host; the exact containment test runs
    as ONE tensor computation over all candidate pairs on `device`."""
    if len(px) == 0 or not polys:
        return []
    verts, nv = pack_vertices(polys)
    # bounds from the UNPADDED vertices: zero padding must not drag the
    # grid to the origin
    allv = np.concatenate([g.reshape(-1, 2) for g in polys])
    xs = np.concatenate([px, allv[:, 0]])
    ys = np.concatenate([py, allv[:, 1]])
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    wx = max(x1 - x0, 1e-12) / grid
    wy = max(y1 - y0, 1e-12) / grid
    cell_x = np.clip(((px - x0) / wx).astype(np.int64), 0, grid - 1)
    cell_y = np.clip(((py - y0) / wy).astype(np.int64), 0, grid - 1)
    pt_cell = cell_x * grid + cell_y
    # points grouped by cell: one stable sort instead of a per-point loop
    order = np.argsort(pt_cell, kind="stable")
    starts = np.searchsorted(pt_cell[order], np.arange(grid * grid), "left")
    ends = np.searchsorted(pt_cell[order], np.arange(grid * grid), "right")
    cand_p, cand_g = [], []
    for gi, g in enumerate(polys):
        gx0 = int(np.clip((g[:, 0].min() - x0) / wx, 0, grid - 1))
        gx1 = int(np.clip((g[:, 0].max() - x0) / wx, 0, grid - 1))
        gy0 = int(np.clip((g[:, 1].min() - y0) / wy, 0, grid - 1))
        gy1 = int(np.clip((g[:, 1].max() - y0) / wy, 0, grid - 1))
        for cx in range(gx0, gx1 + 1):
            for cy in range(gy0, gy1 + 1):
                c = cx * grid + cy
                pts = order[starts[c]:ends[c]]
                cand_p.append(pts)
                cand_g.append(np.full(len(pts), gi, np.int64))
    cp = np.concatenate(cand_p) if cand_p else np.zeros(0, np.int64)
    cg = np.concatenate(cand_g) if cand_g else np.zeros(0, np.int64)
    if not len(cp):
        return []
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    hit = point_in_polygon(t(px[cp], torch.float64), t(py[cp], torch.float64),
                           t(verts[cg], torch.float64), t(nv[cg], torch.int64))
    hit = hit.cpu().numpy()
    return sorted(zip(cp[hit].tolist(), cg[hit].tolist()))
