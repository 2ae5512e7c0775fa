"""North-star query texts (torch counterpart of the query texts of
presto_tpu/benchmark/scale.py).

The texts of TPC-H Q1, Q6, Q3, Q5, Q17 and Q18 as the JAX package's scale
and north-star runners send them, adapted only where the benchmark
generator (benchmark/benchgen.py) lacks a column (Q18: c_name), plus the
Q18-shaped customer rollup. benchmark/northstar.py runs them over the
device-resident catalog.
"""

Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, "
    "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
    "avg(l_quantity) as avg_qty, avg(l_discount) as avg_disc, "
    "count(*) as count_order "
    "from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
Q6 = (
    "select sum(l_extendedprice * l_discount) as revenue from lineitem "
    "where l_shipdate >= date '1994-01-01' "
    "and l_shipdate < date '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24"
)
Q3 = (
    "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as rev, "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 'BUILDING' and c_custkey = o_custkey "
    "and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
    "and l_shipdate > date '1995-03-15' "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by rev desc, o_orderdate limit 10"
)
Q18_SHAPE = (
    "select c_custkey, sum(o_totalprice) tp, count(*) n "
    "from customer, orders "
    "where c_custkey = o_custkey "
    "group by c_custkey order by tp desc limit 100"
)
# the BASELINE.json north stars (round-4 verdict weak#2): Q5 is the
# 6-table join-order stressor; Q17 the large-build correlated-agg /
# spill-path stressor; Q18 the big-group HAVING semi-join. Spec texts
# adapted only where the chunked generator lacks a column (Q18: c_name)
Q5 = (
    "select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue "
    "from customer, orders, lineitem, supplier, nation, region "
    "where c_custkey = o_custkey and l_orderkey = o_orderkey "
    "and l_suppkey = s_suppkey and c_nationkey = s_nationkey "
    "and s_nationkey = n_nationkey and n_regionkey = r_regionkey "
    "and r_name = 'ASIA' and o_orderdate >= date '1994-01-01' "
    "and o_orderdate < date '1995-01-01' "
    "group by n_name order by revenue desc"
)
Q17 = (
    "select sum(l_extendedprice) / 7.0 as avg_yearly "
    "from lineitem, part "
    "where p_partkey = l_partkey and p_brand = 'Brand#23' "
    "and p_container = 'MED BOX' "
    "and l_quantity < ("
    "select 0.2 * avg(l_quantity) from lineitem "
    "where l_partkey = p_partkey)"
)
Q18 = (
    "select c_custkey, o_orderkey, o_orderdate, o_totalprice, "
    "sum(l_quantity) "
    "from customer, orders, lineitem "
    "where o_orderkey in ("
    "select l_orderkey from lineitem group by l_orderkey "
    "having sum(l_quantity) > 300) "
    "and c_custkey = o_custkey and o_orderkey = l_orderkey "
    "group by c_custkey, o_orderkey, o_orderdate, o_totalprice "
    "order by o_totalprice desc, o_orderdate limit 100"
)

QUERIES = {
    "q1": Q1, "q6": Q6, "q3": Q3, "q18_shape": Q18_SHAPE,
    "q5": Q5, "q17": Q17, "q18": Q18,
}

