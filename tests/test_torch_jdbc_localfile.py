"""The SQLite federation and local-file connectors of presto_tpu_torch
(connectors/jdbc.py, connectors/localfile.py) on the CPU, held to the JAX
package: the cases of tests/test_jdbc.py (remote metadata, SQL over a
remote table, projection and predicate pushdown in the generated SQL, a
federated join against TPC-H, the index join, a stale dictionary rebuilt)
and tests/test_localfile.py (schema inference, CSV, JSONL with missing
keys, TSV and a join, a schema override, inference falling back past its
sample, duplicate stems, the Avro codec, the raw fixed-width decoder),
each through both packages on the same files: equal rows, equal
generated remote SQL, equal inferred schemas. Avro files written by either
package read in the other."""

import json
import sqlite3
import struct

import pytest
import torch

import chip_smoke
from presto_tpu import types as RT
from presto_tpu.connectors.jdbc import MultiCatalog as RMultiCatalog
from presto_tpu.connectors.jdbc import SqliteCatalog as RSqliteCatalog
from presto_tpu.connectors.localfile import LocalFileCatalog as RLocalFileCatalog
from presto_tpu.connectors.localfile import read_avro as r_read_avro
from presto_tpu.connectors.localfile import write_avro as r_write_avro
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.jdbc import MultiCatalog, SqliteCatalog
from presto_tpu_torch.connectors.localfile import LocalFileCatalog, read_avro, write_avro
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


def same_rows(got, want, ordered=True):
    diff = chip_smoke.row_diff(got, want, ordered)
    assert diff is None, diff


def sessions(cat, rcat, **kw):
    ref = RSession(rcat, plan_cache=False, result_cache=False, **kw)
    ref.executor.dynamic_filtering = False
    return Session(cat, device="cpu", result_cache=False, **kw), ref


def both(cat, rcat, sql, **kw):
    port, ref = sessions(cat, rcat, **kw)
    got = port.query(sql).rows()
    same_rows(got, ref.query(sql).rows())
    return got


# -- SQLite federation (tests/test_jdbc.py) --

@pytest.fixture()
def db(tmp_path):
    path = str(tmp_path / "remote.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE users (id INTEGER PRIMARY KEY, name TEXT, "
                 "balance REAL, joined DATE, vip BOOLEAN)")
    conn.executemany("INSERT INTO users VALUES (?,?,?,?,?)", [
        (1, "ada", 10.5, "2020-01-02", 1),
        (2, "bob", -3.25, "2021-07-15", 0),
        (3, "cyd", 0.0, "2019-12-31", 1),
        (4, None, 7.75, "2022-03-08", 0),
    ])
    conn.execute("CREATE TABLE empty_t (x INTEGER)")
    conn.commit()
    conn.close()
    return path


def test_metadata_from_remote_catalog(db):
    cat, rcat = SqliteCatalog(db, device="cpu"), RSqliteCatalog(db)
    assert cat.table_names() == rcat.table_names() == ["empty_t", "users"]
    sch = cat.schema("users")
    assert {c: str(t) for c, t in sch.items()} == \
        {c: str(t) for c, t in rcat.schema("users").items()}
    assert (sch["id"], sch["name"], sch["balance"], sch["joined"], sch["vip"]) == \
        (T.BIGINT, T.VARCHAR, T.DOUBLE, T.DATE, T.BOOLEAN)
    assert cat.row_count("users") == 4
    assert cat.unique_columns("users") == rcat.unique_columns("users") == [("id",)]


@pytest.mark.parametrize("sql", [
    "select name, balance from users where vip and balance >= 0 order by name",
    "select count(*) from users where name is null",
    "select id from users where joined > date '2020-06-01' order by id",
    "select count(*) from empty_t",
    "select * from users order by id",
])
def test_sql_queries_over_remote_table(db, sql):
    both(SqliteCatalog(db, device="cpu"), RSqliteCatalog(db), sql)


def test_predicate_and_projection_pushdown(db):
    cat, rcat = SqliteCatalog(db, device="cpu"), RSqliteCatalog(db)
    port, ref = sessions(cat, rcat, streaming=True, batch_rows=2)
    logs = []
    for c, s in ((cat, port), (rcat, ref)):
        c.query_log.clear()
        assert s.query("select balance from users where id = 3").rows() == [(0.0,)]
        logs.append([q for q in c.query_log if "WHERE" in q and "SELECT" in q])
    assert logs[0] == logs[1]
    assert any('"balance"' in q and '"name"' not in q for q in logs[0])
    assert any('"id" = ?' in q for q in logs[0])


def test_federated_join_sqlite_x_tpch(db):
    sql = ("select u.id, u.name, n.n_name from users u, nation n "
           "where u.id = n.n_nationkey and u.balance >= 0 order by u.id")
    got = both(MultiCatalog([SqliteCatalog(db, device="cpu"), TpchCatalog(0.01, device="cpu")]),
               RMultiCatalog([RSqliteCatalog(db), RTpchCatalog(sf=0.01)]), sql)
    assert [r[0] for r in got] == [1, 3, 4]


def test_index_join_fetches_only_matching_rows(db):
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE big_dim (k INTEGER PRIMARY KEY, label TEXT)")
    conn.executemany("INSERT INTO big_dim VALUES (?, ?)", [(i, f"L{i:05d}") for i in range(5000)])
    conn.execute("CREATE TABLE probe (k INTEGER, w INTEGER)")
    conn.executemany("INSERT INTO probe VALUES (?, ?)", [(i * 100, i) for i in range(10)])
    conn.commit()
    conn.close()
    sql = "select p.w, d.label from probe p, big_dim d where p.k = d.k order by p.w"
    cat, rcat = SqliteCatalog(db, device="cpu"), RSqliteCatalog(db)
    port, ref = sessions(cat, rcat, streaming=True, batch_rows=4)
    lookups = []
    for c, s in ((cat, port), (rcat, ref)):
        s.query(sql).rows()  # warm the plan-time statistics sampler
        c.query_log.clear()
        rows = s.query(sql).rows()
        assert len(rows) == 10 and rows[0] == (0, "L00000") and rows[-1] == (9, "L00900")
        assert "index_join" in s.executor.spill_events
        lookups.append([q for q in c.query_log if " IN (" in q])
        assert not [q for q in c.query_log if "big_dim" in q and "LIMIT" in q and " IN (" not in q]
    assert lookups[0] and lookups[0] == lookups[1]


def test_stale_dictionary_rebuilt_on_remote_insert(db):
    cat, rcat = SqliteCatalog(db, device="cpu"), RSqliteCatalog(db)
    sql = "select name from users where name is not null order by name"
    assert both(cat, rcat, sql) == [("ada",), ("bob",), ("cyd",)]
    conn = sqlite3.connect(db)
    conn.execute("INSERT INTO users VALUES (5, 'zed', 1.0, '2023-01-01', 0)")
    conn.commit()
    conn.close()
    assert both(cat, rcat, sql) == [("ada",), ("bob",), ("cyd",), ("zed",)]


# -- local files (tests/test_localfile.py) --

@pytest.fixture()
def files(tmp_path):
    (tmp_path / "people.csv").write_text(
        "name,age,score,joined,active\n"
        "alice,30,1.5,2020-01-02,true\n"
        "bob,25,2.25,2021-06-30,false\n"
        "carol,,3.5,2019-12-31,true\n")
    (tmp_path / "events.jsonl").write_text(
        '{"user": "alice", "n": 3}\n'
        '{"user": "bob", "n": 5, "tag": "x"}\n')
    (tmp_path / "pairs.tsv").write_text("a\tb\n1\t2\n3\t4\n")
    return LocalFileCatalog(str(tmp_path), device="cpu"), RLocalFileCatalog(str(tmp_path))


def test_schema_inference(files):
    cat, rcat = files
    for t in ("people", "events", "pairs"):
        assert {c: str(v) for c, v in cat.schema(t).items()} == \
            {c: str(v) for c, v in rcat.schema(t).items()}
    sch = cat.schema("people")
    assert (sch["name"], sch["age"], sch["score"], sch["joined"], sch["active"]) == \
        (T.VARCHAR, T.BIGINT, T.DOUBLE, T.DATE, T.BOOLEAN)


@pytest.mark.parametrize("sql", [
    "select name, age from people where active order by name",
    "select sum(score) from people",
    "select count(*) from people where joined >= date '2020-01-01'",
    "select * from people order by name",
    "select user, n, tag from events order by user",
    "select a + b from pairs order by 1",
    "select p.name, e.n from people p join events e on p.name = e.user order by 1",
])
def test_queries_over_local_files(files, sql):
    both(*files, sql)


def test_schema_override(tmp_path):
    (tmp_path / "t.csv").write_text("code\n001\n002\n")
    got = both(LocalFileCatalog(str(tmp_path), schemas={"t": {"code": T.VARCHAR}}, device="cpu"),
               RLocalFileCatalog(str(tmp_path), schemas={"t": {"code": RT.VARCHAR}}),
               "select code from t order by 1")
    assert got == [("001",), ("002",)]


def test_inference_fallback_past_sample(tmp_path):
    rows = "\n".join(str(i) for i in range(1100)) + "\nn/a\n"
    (tmp_path / "q.csv").write_text("qty\n" + rows)
    cat = LocalFileCatalog(str(tmp_path), device="cpu")
    assert both(cat, RLocalFileCatalog(str(tmp_path)), "select count(*) from q") == [(1101,)]
    assert cat.schema("q")["qty"] == T.VARCHAR


def test_duplicate_stem_rejected(tmp_path):
    (tmp_path / "d.csv").write_text("a\n1\n")
    (tmp_path / "d.jsonl").write_text('{"a": 1}\n')
    with pytest.raises(ValueError, match="duplicate table"):
        LocalFileCatalog(str(tmp_path), device="cpu")


AVRO_NAMES = ["id", "score", "tag", "ok"]
AVRO_COLS = [[1, 2, 3, 4], [1.5, None, 3.25, -0.5], ["a", "b", None, "a"],
             [True, False, True, None]]


@pytest.mark.parametrize("codec", ["deflate", "null"])
def test_avro_roundtrip_crosses_packages(tmp_path, codec):
    ours, theirs = str(tmp_path / "ours.avro"), str(tmp_path / "theirs.avro")
    write_avro(ours, AVRO_NAMES, AVRO_COLS, codec=codec)
    r_write_avro(theirs, AVRO_NAMES, AVRO_COLS, codec=codec)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert read_avro(theirs) == r_read_avro(ours) == (AVRO_NAMES, AVRO_COLS)


def test_avro_sql(tmp_path):
    write_avro(str(tmp_path / "events.avro"), AVRO_NAMES, AVRO_COLS)
    cat, rcat = LocalFileCatalog(str(tmp_path), device="cpu"), RLocalFileCatalog(str(tmp_path))
    assert both(cat, rcat, "select count(*), sum(id), count(score) from events") == [(4, 10, 3)]
    assert both(cat, rcat, "select tag, count(*) c from events where ok group by tag "
                           "order by tag nulls last") == [("a", 1), (None, 1)]


def test_raw_fixed_width_decoder(tmp_path):
    fields = [{"name": "k", "type": "bigint", "start": 0, "end": 8},
              {"name": "v", "type": "double", "start": 8, "end": 16},
              {"name": "s", "type": "varchar", "start": 16, "end": 24}]
    recs = b"".join(struct.pack(">q", i) + struct.pack(">d", i * 1.5) +
                    f"row{i}".ljust(8).encode() for i in range(5))
    (tmp_path / "fixed.raw").write_bytes(recs)
    (tmp_path / "fixed.rawschema").write_text(json.dumps(fields))
    cat, rcat = LocalFileCatalog(str(tmp_path), device="cpu"), RLocalFileCatalog(str(tmp_path))
    rows = both(cat, rcat, "select k, v, s from fixed order by k")
    assert rows[0] == (0, 0.0, "row0") and rows[4] == (4, 6.0, "row4")
    assert both(cat, rcat, "select sum(v) from fixed") == [(15.0,)]
