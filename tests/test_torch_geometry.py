"""Geometry in presto_tpu_torch (device="cpu") against the JAX package:
ops/geometry.py's kernels (point in polygon, segment tests, containment,
intersection, area, centroid, length, perimeter, the grid spatial join)
against presto_tpu/ops/geometry.py's on the same vertex arrays, and the 23
st_* functions through both packages' Session.query over the same seeded
points. Booleans and integers exact, doubles within
presto_tpu/testing/oracle.py's tolerance. The cases are those of
tests/test_geometry.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.ops import geometry as rgeo
from presto_tpu_torch.ops import geometry as geo
from test_torch_collections import same_rows, sessions_over

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

SQUARE = np.array([(0, 0), (4, 0), (4, 4), (0, 4), (0, 0)], np.float64)
TRIANGLE = np.array([(10, 10), (14, 10), (12, 13), (10, 10)], np.float64)
CONCAVE = np.array([(0, 0), (6, 0), (6, 6), (3, 2), (0, 6), (0, 0)], np.float64)
LINE = np.array([(0, 0), (3, 4), (3, 10)], np.float64)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _equal(r, t):
    r = np.asarray(r)
    t = t.numpy()
    if r.dtype == np.bool_ or np.issubdtype(r.dtype, np.integer):
        assert np.array_equal(r, t)
    else:
        assert np.allclose(r, t, rtol=1e-12, atol=1e-12, equal_nan=True)


def test_point_in_polygon_equals_reference():
    rng = np.random.default_rng(7)
    n = 600
    px = rng.uniform(-1, 7, n)
    py = rng.uniform(-1, 7, n)
    # points exactly on edges and vertices too
    px[:6], py[:6] = [0, 2, 4, 3, 6, 0], [0, 0, 2, 2, 3, 6]
    for poly in (SQUARE, CONCAVE, TRIANGLE):
        verts, nv = geo.pack_vertices([poly] * n)
        (rx, ry, rv, rn), (tx, ty, tv, tn) = _both(px, py, verts, nv)
        _equal(rgeo.point_in_polygon(rx, ry, rv, rn), geo.point_in_polygon(tx, ty, tv, tn))


def test_measures_and_predicates_equal_reference():
    geoms = [SQUARE, TRIANGLE, CONCAVE, LINE, SQUARE + 1.5, CONCAVE * 0.5]
    verts, nv = geo.pack_vertices(geoms)
    (rv, rn), (tv, tn) = _both(verts, nv)
    for fn in ("polygon_area", "line_length", "ring_perimeter", "is_closed_ring"):
        _equal(getattr(rgeo, fn)(rv, rn), getattr(geo, fn)(tv, tn))
    for r, t in zip(rgeo.polygon_centroid(rv, rn), geo.polygon_centroid(tv, tn)):
        _equal(r, t)
    # every ordered pair of geometries
    i, j = np.meshgrid(np.arange(len(geoms)), np.arange(len(geoms)), indexing="ij")
    i, j = i.ravel(), j.ravel()
    (ra, rna, rb, rnb), (ta, tna, tb, tnb) = _both(verts[i], nv[i], verts[j], nv[j])
    _equal(rgeo.contains_all_vertices(ra, rna, rb, rnb),
           geo.contains_all_vertices(ta, tna, tb, tnb))
    _equal(rgeo.polygons_intersect(ra, rna, rb, rnb), geo.polygons_intersect(ta, tna, tb, tnb))
    a1, a2 = verts[i, 0], verts[i, 1]
    b1, b2 = verts[j, 1], verts[j, 2]
    (r1, r2, r3, r4), (t1, t2, t3, t4) = _both(a1, a2, b1, b2)
    _equal(rgeo.segments_intersect(r1, r2, r3, r4), geo.segments_intersect(t1, t2, t3, t4))
    _equal(rgeo.segments_cross_properly(r1, r2, r3, r4),
           geo.segments_cross_properly(t1, t2, t3, t4))


def test_parse_and_pack_equal_reference():
    for wkt in ("POINT (1 2)", "LINESTRING(0 0, 3 4, 3 10)", "POLYGON((0 0, 4 0, 4 4, 0 4))",
                "polygon ((1.5 -2e1, 3 0, 2 5, 1.5 -2e1))"):
        rk, rv = rgeo.parse_wkt(wkt)
        tk, tv = geo.parse_wkt(wkt)
        assert rk == tk and np.array_equal(rv, tv)
    for bad in ("POLYGON((0 0, 1 0, 1 1, 0 0), (0.1 0.1, 0.2 0.1, 0.2 0.2, 0.1 0.1))",
                "CIRCLE(1 1)", "POINT EMPTY"):
        with pytest.raises(ValueError):
            geo.parse_wkt(bad)


@pytest.mark.parametrize("seed,far", [(3, False), (4, True)])
def test_grid_spatial_join_equals_reference(seed, far):
    rng = np.random.default_rng(seed)
    off = 1000.0 if far else 0.0
    px = rng.uniform(0, 10, 400) + off
    py = rng.uniform(0, 10, 400) + off
    polys = [SQUARE + off, TRIANGLE - 5 + off, CONCAVE + off,
             np.array([(1, 1), (9, 1), (5, 9), (1, 1)], np.float64) + off]
    got = geo.grid_spatial_join(px, py, polys, grid=8, device="cpu")
    assert got == rgeo.grid_spatial_join(px, py, polys, grid=8)
    assert len(got) > 0


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(5)
    n = 100
    return sessions_over({"x": rng.uniform(0, 6, n), "y": rng.uniform(0, 6, n),
                          "id": np.arange(n, dtype=np.int64)}, "pts")


POLY = "st_polygon('POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))')"
LINE_SQL = "st_linefromtext('LINESTRING(0 0, 3 4, 3 10)')"
U = "st_polygon('POLYGON((0 0, 6 0, 6 6, 4 6, 4 2, 2 2, 2 6, 0 6, 0 0))')"
SQL = {
    "contains_points": f"select count(*) from pts where st_contains({POLY}, st_point(x, y))",
    "within_points": f"select id from pts where st_within(st_point(x, y), {U}) order by id",
    "point_accessors": "select id, st_x(st_point(x, y)), st_y(st_point(x, y)), "
                       "st_distance(st_point(x, y), st_point(3.0, 3.0)) from pts order by id",
    "measures": f"select st_area({POLY}), st_perimeter({POLY}), st_xmax({POLY}), "
                f"st_ymin({POLY}), st_xmin({U}), st_ymax({U}), st_numpoints({POLY}), "
                f"st_isclosed({POLY}), st_isclosed({LINE_SQL}), st_isempty({POLY}), "
                f"st_centroid({POLY}), st_x(st_centroid({U})), st_length({LINE_SQL}) "
                "from pts limit 1",
    "envelope": "select st_envelope(st_polygon('POLYGON((1 1, 3 0, 5 4, 2 5, 1 1))')), "
                "st_contains(st_envelope(st_polygon('POLYGON((1 1, 3 0, 5 4, 2 5, 1 1))')), "
                "st_polygon('POLYGON((1 1, 3 0, 5 4, 2 5, 1 1))')) from pts limit 1",
    "intersects": "select st_intersects(st_polygon('POLYGON((0 0, 2 0, 2 2, 0 2, 0 0))'), "
                  "st_polygon('POLYGON((1 1, 3 1, 3 3, 1 3, 1 1))')), "
                  "st_disjoint(st_polygon('POLYGON((0 0, 2 0, 2 2, 0 2, 0 0))'), "
                  "st_polygon('POLYGON((5 5, 6 5, 6 6, 5 6, 5 5))')), "
                  "st_intersects(st_linefromtext('LINESTRING(0 0, 4 0, 4 4)'), "
                  "st_linefromtext('LINESTRING(0.2 1, 1 0.2)')) from pts limit 1",
    "concave_container": f"select st_contains({U}, st_polygon('POLYGON((0.5 3, 5.5 3, 5.5 5, "
                         f"0.5 5, 0.5 3))')), st_contains({U}, st_polygon('POLYGON((0.5 3, "
                         "1.5 3, 1.5 5, 0.5 5, 0.5 3))')) from pts limit 1",
    "geometry_from_text": "select st_numpoints(st_geometryfromtext('POINT (1 2)')), "
                          "st_x(st_geometryfromtext('POINT (1 2)')), "
                          "st_geometryfromtext('LINESTRING(0 0, 1 1)') from pts limit 1",
    "per_row_polygons": "select id, st_area(st_polygon(case when id % 2 = 0 then "
                        "'POLYGON((0 0, 2 0, 2 2, 0 2, 0 0))' else "
                        "'POLYGON((0 0, 3 0, 0 3, 0 0))' end)) from pts order by id limit 6",
}


@pytest.mark.parametrize("name", list(SQL))
def test_equals_reference(name, sessions):
    port, ref = sessions
    got = port.query(SQL[name]).rows()
    assert got
    same_rows(got, ref.query(SQL[name]).rows())


def test_point_counts_against_direct_test(sessions):
    port, _ref = sessions
    n_in = port.query(SQL["contains_points"]).rows()[0][0]
    rows = port.query("select x, y from pts").rows()
    assert n_in == sum(1 for x, y in rows if 0 <= x <= 4 and 0 <= y <= 4) > 0


def test_spatial_join_nested_loop(sessions):
    """A spatial predicate in a join condition runs as a nested-loop
    filter, in the port with the polygon column carried through the join
    (the JAX package's join drops its lengths, ROADMAP queue 3)."""
    port, _ref = sessions
    rows = port.query("select count(*) from pts a, pts b where "
                      "st_distance(st_point(a.x, a.y), st_point(b.x, b.y)) < 0.5").rows()
    assert rows[0][0] >= 100
    got = port.query("with g as (select id gid, st_polygon(case when id = 0 then "
                     "'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))' else "
                     "'POLYGON((2 2, 6 2, 6 6, 2 6, 2 2))' end) poly from pts where id < 2) "
                     "select gid, count(*) from g, pts where st_contains(poly, st_point(x, y)) "
                     "group by gid order by gid").rows()
    pts = port.query("select x, y from pts").rows()
    assert got == [(0, sum(0 <= x <= 4 and 0 <= y <= 4 for x, y in pts)),
                   (1, sum(2 <= x <= 6 and 2 <= y <= 6 for x, y in pts))]
