"""Multi-statement transactions through presto_tpu_torch.Session
(device="cpu") against presto_tpu.Session: BEGIN/COMMIT/ROLLBACK over the
overlay catalog (exec/transaction.py) with read-your-writes, the local
cases of the JAX package's tests/test_transactions.py (its REST cases need
the server, not ported). Every statement runs through both packages."""

import numpy as np
import pytest
import torch

from presto_tpu_torch.exec.transaction import TransactionCatalog
from test_torch_statements import Pair

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)


@pytest.fixture()
def sess():
    return Pair({"t": {"v": np.array([1, 2, 3])}})


def names(pair):
    return [r[0] for r in pair.q("show tables")]


def test_commit_applies_staged_writes(sess):
    sess.q("begin")
    sess.q("insert into t values (4), (5)")
    # read-your-writes inside the transaction
    assert sess.q("select count(*) from t") == [(5,)]
    sess.q("commit")
    assert sess.q("select count(*) from t") == [(5,)]


def test_rollback_discards_everything(sess):
    sess.q("start transaction")
    sess.q("insert into t values (9)")
    sess.q("create table made (x bigint)")
    sess.q("insert into made values (1)")
    assert sess.q("select count(*) from made") == [(1,)]
    sess.q("rollback")
    assert sess.q("select count(*) from t") == [(3,)]
    sess.fails("select * from made", "Exception")


def test_delete_and_drop_staged(sess):
    sess.q("begin")
    sess.q("delete from t where v >= 2")
    assert sess.q("select sum(v) from t") == [(1,)]
    sess.q("commit")
    assert sess.q("select sum(v) from t") == [(1,)]
    sess.q("begin")
    sess.q("drop table t")
    assert "t" not in names(sess)
    sess.q("rollback")
    assert sess.q("select count(*) from t") == [(1,)]


def test_nested_and_stray_txn_errors(sess):
    sess.q("begin")
    sess.fails("begin", match="already in progress")
    sess.q("rollback")
    sess.fails("commit", match="no transaction")


def test_create_then_commit_lands_in_base(sess):
    base = sess.port.catalog
    sess.q("begin")
    sess.q("create table fresh as select v * 10 m from t")
    sess.q("commit")
    assert sess.q("select sum(m) from fresh") == [(60,)]
    assert "fresh" in base.table_names()


def test_drop_then_recreate_in_one_txn(sess):
    sess.q("begin")
    sess.q("drop table t")
    sess.q("create table t as select 42 v from (values (1)) x(a)")
    sess.q("commit")
    assert sess.q("select v from t") == [(42,)]


def test_drop_recreate_drop_stays_dropped(sess):
    sess.q("begin")
    sess.q("drop table t")
    sess.q("create table t as select 1 v from (values (1)) x(a)")
    sess.q("drop table t")
    assert "t" not in names(sess)
    sess.q("commit")
    assert "t" not in sess.port.catalog.table_names()


def test_staged_pages_stay_on_the_base_device(sess):
    """Inside a transaction the session reads the overlay, whose staged
    pages (created, appended, replaced) live on the base catalog's
    device."""
    sess.q("begin")
    txn = sess.port.catalog
    assert isinstance(txn, TransactionCatalog) and txn.device.type == "cpu"
    sess.q("create table e (x bigint, s varchar)")
    sess.q("insert into e values (1, 'a'), (2, 'b')")
    sess.q("insert into t values (7)")
    sess.q("delete from t where v = 1")
    for name in ("e", "t"):
        assert all(b.data.device.type == "cpu" for b in txn.page(name).blocks)
    assert sess.q("select s from e order by x") == [("a",), ("b",)]
    sess.q("commit")
    assert sess.q("select count(*), sum(v) from t") == [(3, 12)]


def test_overlay_stats_follow_the_staged_rows(sess):
    """A table the transaction has not written takes the base catalog's
    (cached) column stats; a staged one is sampled from the staged rows."""
    base = sess.port.catalog
    sess.q("begin")
    txn = sess.port.catalog
    assert txn.column_stats("t", "v") is base.column_stats("t", "v")
    sess.q("insert into t values (10), (20)")
    staged = txn.column_stats("t", "v")
    assert (staged.ndv, staged.max) == (5, 20.0)
    assert (base.column_stats("t", "v").ndv, base.column_stats("t", "v").max) == (3, 3.0)
    sess.q("rollback")
