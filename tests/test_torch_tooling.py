"""The port's client tooling on the CPU (presto_tpu_torch/dbapi.py, cli.py,
verifier.py, server/auth.py, server/proxy.py), after tests/test_tooling.py
and tests/test_auth_tls.py:

* the verifier: matches, mismatches, failures, REST targets, and row
  digests equal to the JAX package's over the same rows;
* DB-API: a round trip, parameters bound server-side, error wrapping,
  and placeholder substitution equal to the JAX package's;
* the CLI's statement splitting against the JAX package's, and
  `--serve` on the CPU answering a Client;
* Basic credentials from a password file, TLS with an openssl-made
  certificate, the asserted user against the principal, and the
  authenticating proxy.

Every server binds port 0 and stops in a finally; every HTTP call has a
timeout."""

import datetime
import decimal
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu import cli as rcli
from presto_tpu import dbapi as rdbapi
from presto_tpu import verifier as rverifier
from presto_tpu_torch import cli, dbapi, verifier
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.server.auth import (
    AuthenticationError,
    FilePasswordAuthenticator,
    basic_auth_header,
    generate_self_signed_cert,
    hash_password,
    parse_basic_auth,
)
from presto_tpu_torch.server.client import Client, QueryError
from presto_tpu_torch.server.coordinator import CoordinatorServer
from presto_tpu_torch.session import Session

torch.set_num_threads(1)

SF = 0.002
TIMEOUT = 60
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _session(sf=SF):
    return Session(TpchCatalog(sf, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def server():
    srv = CoordinatorServer(_session(), max_concurrent=2).start()
    try:
        yield srv
    finally:
        srv.stop()


# -- verifier -----------------------------------------------------------------


def test_verifier_match_and_mismatch():
    control = verifier.SessionTarget(_session())
    results = verifier.verify_suite(control, verifier.SessionTarget(_session()), [
        "select count(*) from orders",
        "select o_orderpriority, count(*) c from orders group by 1"])
    assert all(r.status == "MATCH" for r in results)
    bad = verifier.verify_suite(control, verifier.SessionTarget(_session(0.004)),
                                ["select count(*) from orders"])
    assert bad[0].status == "MISMATCH"
    assert "row count" in bad[0].detail or "checksum" in bad[0].detail


def test_verifier_reports_failures():
    control = verifier.SessionTarget(_session())
    test = verifier.SessionTarget(Session(MemoryCatalog({}, device="cpu"), device="cpu"))
    assert verifier.verify_query(control, test, "select count(*) from orders").status == \
        "TEST_FAILED"
    assert verifier.verify_query(test, control, "select count(*) from orders").status == \
        "CONTROL_FAILED"


def test_verifier_rest_targets(server):
    a, b = verifier.RestTarget(server.uri), verifier.RestTarget(server.uri)
    assert verifier.verify_suite(a, b, ["select count(*) from lineitem"])[0].status == "MATCH"


_DIGEST_ROWS = [
    [(1, "a"), (2, "b")],
    [(2, "b"), (1, "a")],
    [(1, "a"), (1, "a")],
    [(2, "b"), (2, "b")],
    [(None, 1.5, float("nan"), True)],
    [(decimal.Decimal("12.34"), datetime.date(1995, 3, 15), np.int64(7), 2.0, -0.0)],
    [(1e-300, 123456789.123456789, "x\x01y", False)],
    [],
]


@pytest.mark.parametrize("i", range(len(_DIGEST_ROWS)))
def test_row_digest_equal_across_packages(i):
    assert verifier.row_digest(_DIGEST_ROWS[i]) == rverifier.row_digest(_DIGEST_ROWS[i])


def test_row_digest_order_free_and_no_even_cancellation():
    assert verifier.row_digest(_DIGEST_ROWS[0]) == verifier.row_digest(_DIGEST_ROWS[1])
    assert verifier.row_digest(_DIGEST_ROWS[2]) != verifier.row_digest(_DIGEST_ROWS[3])


def test_digest_of_query_rows_equal_across_packages():
    from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
    from presto_tpu.session import Session as RSession

    sql = ("select o_orderpriority, count(*), sum(o_totalprice), min(o_orderdate) from orders "
           "group by o_orderpriority")
    mine = _session().query(sql).rows()
    ref = RSession(RCatalog(sf=SF)).query(sql).rows()
    assert verifier.row_digest(mine) == rverifier.row_digest(ref)


def test_suite_file_and_main(server, tmp_path, capsys):
    suite = tmp_path / "suite.sql"
    suite.write_text("-- a comment\nselect count(*) from nation;\nselect count(*) from region;\n")
    assert verifier.load_suite(str(suite)) == rverifier.load_suite(str(suite))
    assert verifier.main(["--control", server.uri, "--test", server.uri, str(suite)]) == 0
    assert "# 2/2 matched" in capsys.readouterr().out


# -- DB-API -------------------------------------------------------------------


def test_dbapi_roundtrip(server):
    with dbapi.connect(server.uri, timeout=TIMEOUT) as conn:
        cur = conn.cursor()
        cur.execute("select count(*) c from orders")
        assert cur.description[0][0] == "c"
        assert cur.fetchone()[0] == 3000
        assert cur.fetchone() is None
        cur.execute("select o_orderkey, o_orderpriority from orders"
                    " where o_orderkey <= ? order by 1 limit ?", (10, 3))
        rows = cur.fetchall()
        assert [r[0] for r in rows] == [1, 2, 3]
        assert cur.rowcount == 3
        cur.executemany("select count(*) from orders where o_orderkey <= ?", [(1,), (3,)])
        assert cur.fetchall() == [(3,)]


@pytest.mark.parametrize("sql,params", [
    ("select ?", (5,)),
    ("select '?', ?", ("a'b",)),
    ("select ?", (datetime.date(2020, 2, 2),)),
    ("select ?, ?", (None, True)),
    ("select ?", (decimal.Decimal("1.25"),)),
    ("select x from t where y = ? -- why?", (5,)),
    ('select "a?b" from t /* ?? */ where z = ?', (1,)),
])
def test_dbapi_substitution_equal_across_packages(sql, params):
    assert dbapi._substitute(sql, params) == rdbapi._substitute(sql, params)


@pytest.mark.parametrize("params", [(), (1, 2)])
def test_dbapi_substitution_arity(params):
    with pytest.raises(dbapi.ProgrammingError):
        dbapi._substitute("select ?", params)


def test_dbapi_error_wrapping(server):
    conn = dbapi.connect(server.uri, timeout=TIMEOUT)
    cur = conn.cursor()
    with pytest.raises(dbapi.DatabaseError):
        cur.execute("select bogus_column from orders")
    conn.close()
    with pytest.raises(dbapi.InterfaceError):
        cur.execute("select 1")


def test_web_ui_lists_dbapi_queries(server):
    dbapi.connect(server.uri, timeout=TIMEOUT).cursor().execute("select count(*) from nation")
    with urllib.request.urlopen(server.uri + "/", timeout=TIMEOUT) as r:
        html = r.read().decode()
    assert "presto-tpu coordinator" in html and "Resource groups" in html
    assert "select count(*) from nation" in html


# -- CLI ----------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "select 1; select 2;",
    "select 'a;b'; select ';'",
    "select 'it''s; fine'",
    'select "x;y" from t;;  ; select 3',
    "",
])
def test_cli_split_statements_equal_across_packages(text):
    assert cli.split_statements(text) == rcli.split_statements(text)


def test_cli_runs_statements_on_the_cpu(capsys):
    cli.main(["--device", "cpu", "--sf", "0.001",
              "select count(*) c from region; select r_name from region order by 1 limit 2"])
    out = capsys.readouterr().out
    assert "(1 rows in" in out and "AFRICA" in out and "(2 rows in" in out


def test_cli_serve_answers_a_client():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "presto_tpu_torch.cli", "--serve", "--port", "0",
         "--device", "cpu", "--sf", "0.001"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.time() + TIMEOUT
        while "listening on" not in line and time.time() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "the coordinator exited"
        uri = line.split("listening on ")[1].split()[0]
        _cols, rows = Client(uri, timeout=TIMEOUT).execute("select count(*) from nation")
        assert rows == [[25]]
        assert Client(uri, timeout=TIMEOUT).node_info()["coordinator"] is True
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT)


def test_cli_remote_mode(server, capsys):
    cli.main(["--server", server.uri, "select count(*) n from region"])
    assert "(1 rows in" in capsys.readouterr().out


# -- authentication and TLS ---------------------------------------------------


@pytest.fixture()
def pwfile(tmp_path):
    path = str(tmp_path / "passwords")
    FilePasswordAuthenticator.write(path, {"alice": "open-sesame", "bob": "hunter2"})
    return path


def test_password_file_roundtrip_and_reference_file(pwfile, tmp_path):
    from presto_tpu.server.auth import FilePasswordAuthenticator as RAuth

    for auth in (FilePasswordAuthenticator(pwfile), RAuth(pwfile)):
        assert auth.authenticate("alice", "open-sesame") == "alice"
        with pytest.raises(Exception):
            auth.authenticate("alice", "wrong")
        with pytest.raises(Exception):
            auth.authenticate("eve", "open-sesame")
    # a file the JAX package wrote is read by the port
    ref_path = str(tmp_path / "ref_passwords")
    RAuth.write(ref_path, {"carol": "pass3"})
    assert FilePasswordAuthenticator(ref_path).authenticate("carol", "pass3") == "carol"
    with pytest.raises(AuthenticationError):
        FilePasswordAuthenticator(ref_path).authenticate("carol", "nope")
    assert hash_password("x") != hash_password("x")


def test_basic_header_roundtrip():
    from presto_tpu.server.auth import basic_auth_header as rheader

    assert basic_auth_header("alice", "p:w") == rheader("alice", "p:w")
    assert parse_basic_auth(basic_auth_header("alice", "p:w")) == ("alice", "p:w")
    assert parse_basic_auth("Bearer x") is None and parse_basic_auth(None) is None


def test_http_rejects_without_credentials(pwfile):
    srv = CoordinatorServer(_session(0.001),
                            authenticator=FilePasswordAuthenticator(pwfile)).start()
    try:
        with pytest.raises(QueryError, match="401"):
            Client(srv.uri, timeout=TIMEOUT).execute("select 1 from region limit 1")
        with pytest.raises(QueryError, match="401"):
            Client(srv.uri, user="alice", password="nope", timeout=TIMEOUT).execute(
                "select 1 from region limit 1")
        _cols, rows = Client(srv.uri, user="alice", password="open-sesame",
                             timeout=TIMEOUT).execute("select count(*) c from region")
        assert rows == [[5]]
        assert srv.manager.list_queries()[-1].user == "alice"
        with urllib.request.urlopen(f"{srv.uri}/v1/info", timeout=TIMEOUT) as r:
            assert json.loads(r.read())["coordinator"] is True  # health stays open
    finally:
        srv.stop()


def test_asserted_user_must_match_principal(pwfile):
    srv = CoordinatorServer(_session(0.001),
                            authenticator=FilePasswordAuthenticator(pwfile)).start()
    try:
        req = urllib.request.Request(f"{srv.uri}/v1/statement",
                                     data=b"select 1 from region limit 1", method="POST")
        req.add_header("Authorization", basic_auth_header("alice", "open-sesame"))
        req.add_header("X-Presto-User", "bob")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert exc.value.code == 403
    finally:
        srv.stop()


def test_https_end_to_end(pwfile, tmp_path):
    cert, key = generate_self_signed_cert(str(tmp_path))
    srv = CoordinatorServer(_session(0.001), authenticator=FilePasswordAuthenticator(pwfile),
                            tls=(cert, key)).start()
    try:
        uri = f"https://127.0.0.1:{srv.port}"
        assert srv.uri == uri
        with pytest.raises(QueryError, match="401"):
            Client(uri, user="bob", password="wrong", cafile=cert, timeout=TIMEOUT).execute(
                "select 1 from region limit 1")
        _cols, rows = Client(uri, user="bob", password="hunter2", cafile=cert,
                             timeout=TIMEOUT).execute("select count(*) c from nation")
        assert rows == [[25]]
        with pytest.raises(Exception):
            Client(f"http://127.0.0.1:{srv.port}", user="bob", password="hunter2",
                   timeout=TIMEOUT).execute("select 1 from region")
    finally:
        srv.stop()


def test_proxy_forwards_and_rewrites(pwfile, tmp_path):
    from presto_tpu_torch.server.proxy import ProxyServer

    coord = CoordinatorServer(_session(0.001), authenticator=FilePasswordAuthenticator(pwfile),
                              impersonation_principals={"alice"}).start()
    proxy_pw = str(tmp_path / "proxy_pw")
    FilePasswordAuthenticator.write(proxy_pw, {"carol": "pass3"})
    proxy = ProxyServer(coord.uri, authenticator=FilePasswordAuthenticator(proxy_pw),
                        backend_user="alice", backend_password="open-sesame").start()
    try:
        client = Client(proxy.uri, user="carol", password="pass3", timeout=TIMEOUT)
        _cols, rows = client.execute("select o_orderkey from orders order by 1 limit 1500")
        assert len(rows) == 1500  # two pages: the nextUri was rewritten to the proxy
        with pytest.raises(QueryError, match="401"):
            Client(proxy.uri, user="carol", password="bad", timeout=TIMEOUT).execute(
                "select 1 from region limit 1")
        assert client.queries()
        assert all(i.user == "carol" for i in coord.manager.list_queries())
    finally:
        proxy.stop()
        coord.stop()


def test_proxy_502_when_backend_down():
    from presto_tpu_torch.server.proxy import ProxyServer

    proxy = ProxyServer("http://127.0.0.1:1").start()
    try:
        with pytest.raises(QueryError, match="502"):
            Client(proxy.uri, timeout=TIMEOUT).execute("select 1")
    finally:
        proxy.stop()
