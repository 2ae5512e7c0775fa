"""Coordinator HTTP server: the client statement protocol (torch
counterpart of presto_tpu/server/coordinator.py, the same protocol and
JSON).

Re-designed equivalent of the reference's server layer (SURVEY L2):
StatementResource (`POST /v1/statement`, server/protocol/
StatementResource.java:84,128) with QueryResults nextUri paging
(presto-client/.../QueryResults.java:41), QueryResource listings,
NodeResource-style /v1/info + /v1/status, and graceful shutdown
(server/GracefulShutdownHandler.java:43). Python stdlib HTTP (threading
server) replaces airlift/Jetty: the control plane is latency-bound, not
throughput-bound; the data plane stays on the card. A query's result is
copied to the host once when it finishes, and the pages of the protocol
are cut from that copy.

Protocol (wire-compatible in spirit, JSON):
  POST /v1/statement            body = SQL   -> QueryResults JSON
  GET  /v1/statement/{id}/{token}?maxWait=s  -> next QueryResults chunk
  DELETE /v1/statement/{id}                  -> cancel
  GET  /v1/query                             -> query list
  GET  /v1/query/{id}                        -> detail incl. plan
  GET  /v1/info | /v1/status                 -> node info / liveness
  PUT  /v1/info/state  body='"SHUTTING_DOWN"'-> graceful shutdown
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .state import FINISHED, QueryManager

PAGE_ROWS = 1000  # rows per QueryResults chunk (client paging)
VERSION = "presto-tpu/0.2"


def _json_default(v):
    import datetime
    import decimal

    if isinstance(v, (decimal.Decimal,)):
        return str(v)
    if hasattr(v, "item"):
        return v.item()
    if isinstance(v, (datetime.date,)):
        return v.isoformat()
    return str(v)


class CoordinatorServer:
    """Embeddable coordinator (reference TestingPrestoServer): wraps a
    Session in a QueryManager and serves the REST protocol."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 0,
                 max_concurrent: int = 1, resource_groups=None,
                 selectors=None, listeners=None, node_manager=None,
                 access_control=None, authenticator=None, tls=None,
                 impersonation_principals=(), cluster_pressure=None):
        # expose system.runtime.* through the served session's catalog
        # (reference connector/system/; the user's own session is untouched),
        # on the session's device. Duck-typed sessions (HttpClusterSession)
        # are served as they are: they execute on remote workers whose
        # catalogs are not rewritten.
        from ..connectors.system import SystemCatalog
        from ..session import Session

        self.syscat = None
        served = session
        if isinstance(session, Session):
            syscat = SystemCatalog(session.catalog)
            served = Session(
                syscat,
                device=session.device,
                mesh=session.mesh,
                broadcast_threshold=session.broadcast_threshold,
                exchange_budget=session.exchange_budget,
                streaming=session.streaming,
                batch_rows=session.batch_rows,
                memory_budget=session.memory_budget,
                access_control=session.access_control,
                user=session.user,
                pallas_groupby=session.pallas_groupby,
                dynamic_filtering=session.dynamic_filtering,
                plan_cache=session.plan_cache,
                result_cache=session.result_cache,
            )
            self.syscat = syscat
        # cluster_pressure: the admission gate fed by the cluster memory
        # manager (HttpClusterSession.memory_manager.above_watermark): new
        # queries queue while the fleet is above the revocation watermark.
        # Derived for cluster sessions.
        if cluster_pressure is None:
            mm = getattr(session, "memory_manager", None)
            if mm is not None:
                cluster_pressure = mm.above_watermark
        self.manager = QueryManager(
            served, max_concurrent=max_concurrent,
            resource_groups=resource_groups, selectors=selectors,
            listeners=listeners, access_control=access_control,
            cluster_pressure=cluster_pressure,
        )
        if self.syscat is not None:
            self.syscat.manager = self.manager
            self.syscat.node_manager = node_manager
        # resource-group occupancy on /v1/metrics: a scrape-time
        # producer under a fixed key (a re-created coordinator replaces
        # the previous registration, never accumulates)
        from ..obs.export import register_resource_groups

        register_resource_groups(self.manager.groups)
        self.started_at = time.time()
        self.shutting_down = False
        self.authenticator = authenticator
        self.tls = tls
        # principals allowed to run queries AS another user (reference:
        # principal-to-user impersonation rules in SystemAccessControl) —
        # how an authenticating proxy forwards its clients' identities
        self.impersonation_principals = frozenset(impersonation_principals)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _authenticate(self):
                """With an authenticator installed, the principal comes
                from Basic credentials and X-Presto-User must match it —
                the header alone is no longer trusted (reference
                server/security + password authenticators). Returns the
                authenticated user, or None after sending 401."""
                if outer.authenticator is None:
                    return self.headers.get("X-Presto-User", "user")
                from .auth import AuthenticationError, parse_basic_auth

                creds = parse_basic_auth(self.headers.get("Authorization"))
                if creds is None:
                    self.send_response(401)
                    self.send_header(
                        "WWW-Authenticate", 'Basic realm="presto"'
                    )
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return None
                try:
                    principal = outer.authenticator.authenticate(*creds)
                except AuthenticationError as e:
                    self._send(401, {"error": str(e)})
                    return None
                asserted = self.headers.get("X-Presto-User")
                if asserted and asserted != principal:
                    if principal in outer.impersonation_principals:
                        return asserted  # e.g. the proxy's clients
                    self._send(
                        403,
                        {"error": f"user {asserted!r} does not match "
                                  f"authenticated principal {principal!r}"},
                    )
                    return None
                return principal

            # -- helpers --
            def _send(self, code: int, payload, content_type="application/json"):
                body = (
                    payload
                    if isinstance(payload, bytes)
                    else json.dumps(payload, default=_json_default).encode()
                )
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n)

            # -- routes --
            def do_POST(self):
                if self.path == "/v1/statement":
                    if outer.shutting_down:
                        self._send(503, {"error": "shutting down"})
                        return
                    sql = self._read_body().decode()
                    user = self._authenticate()
                    if user is None:
                        return
                    source = self.headers.get("X-Presto-Source")
                    props_hdr = self.headers.get("X-Presto-Session", "")
                    try:
                        from ..session import parse_session_properties

                        props = parse_session_properties(props_hdr)
                    except ValueError as e:
                        self._send(400, {"error": str(e)})
                        return
                    info = outer.manager.submit(
                        sql, user=user, source=source, properties=props
                    )
                    # immediate first response: QUEUED with nextUri
                    self._send(200, outer._query_results(info, 0))
                    return
                self._send(404, {"error": "not found"})

            def do_GET(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                # health/status/metrics stay unauthenticated (load
                # balancers, cluster heartbeats, Prometheus scrapers);
                # every data-bearing surface requires the principal
                if parts[:2] not in (
                    ["v1", "info"], ["v1", "status"], ["v1", "metrics"]
                ) and (self._authenticate() is None):
                    return
                qs = {}
                if "?" in self.path:
                    for kv in self.path.split("?", 1)[1].split("&"):
                        if "=" in kv:
                            k, v = kv.split("=", 1)
                            qs[k] = v
                if parts[:2] == ["v1", "statement"] and len(parts) == 4:
                    qid, token = parts[2], int(parts[3])
                    info = outer.manager.get(qid)
                    if info is None:
                        self._send(404, {"error": f"unknown query {qid}"})
                        return
                    max_wait = float(qs.get("maxWait", 1.0))
                    if not info.done:
                        info = outer.manager.wait(qid, max_wait)
                        if info is None:  # purged while waiting
                            self._send(404, {"error": f"query {qid} expired"})
                            return
                    self._send(200, outer._query_results(info, token))
                    return
                if parts[:2] == ["v1", "query"] and len(parts) == 2:
                    self._send(
                        200,
                        [outer._query_summary(i) for i in outer.manager.list_queries()],
                    )
                    return
                if parts[:2] == ["v1", "query"] and len(parts) == 3:
                    info = outer.manager.get(parts[2])
                    if info is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    d = outer._query_summary(info)
                    if info.plan is None and info.error is None:
                        try:  # lazily rendered on the detail endpoint only
                            info.plan = outer.manager.session.explain(info.sql)
                        except Exception:  # noqa: BLE001 - the plan is UI
                            # decoration; the query detail (incl. its real
                            # error field) is served regardless
                            pass
                    d["plan"] = info.plan
                    d["error"] = info.error
                    self._send(200, d)
                    return
                if parts == ["v1", "info"]:
                    self._send(
                        200,
                        {
                            "nodeVersion": VERSION,
                            "coordinator": True,
                            "uptime_s": round(time.time() - outer.started_at, 1),
                            "state": "SHUTTING_DOWN"
                            if outer.shutting_down
                            else "ACTIVE",
                        },
                    )
                    return
                if parts == ["v1", "status"]:
                    from ..exec import qcache

                    # serving-cache observability (exec/qcache.py):
                    # hits, misses, evictions and bytes of the plan,
                    # result and history caches
                    self._send(200, {
                        "state": "ACTIVE",
                        "version": VERSION,
                        "caches": qcache.snapshot_all(),
                    })
                    return
                if parts == ["v1", "metrics"]:
                    # Prometheus text exposition 0.0.4 over the
                    # MetricsRegistry (obs/metrics.py): every stats silo
                    # (caches, exchange, wire, scheduler, kernel profile,
                    # resource groups) in one scrape
                    from ..obs.metrics import METRICS

                    self._send(
                        200, METRICS.render().encode(),
                        content_type=(
                            "text/plain; version=0.0.4; charset=utf-8"
                        ),
                    )
                    return
                if not parts or parts == ["ui"]:
                    self._send(
                        200, outer._render_ui().encode(),
                        content_type="text/html; charset=utf-8",
                    )
                    return
                if parts[:1] == ["query"] and len(parts) == 2:
                    page = outer._render_query_detail(parts[1])
                    if page is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    self._send(
                        200, page.encode(),
                        content_type="text/html; charset=utf-8",
                    )
                    return
                if parts == ["timeline"]:
                    self._send(
                        200, outer._render_timeline().encode(),
                        content_type="text/html; charset=utf-8",
                    )
                    return
                if parts == ["v1", "resourceGroupState"]:
                    self._send(
                        200,
                        [
                            {
                                "group": s.name,
                                "running": s.running,
                                "queued": s.queued,
                                "cpu_used_s": round(s.cpu_used_s, 3),
                            }
                            for s in outer.manager.groups.stats()
                        ],
                    )
                    return
                self._send(404, {"error": "not found"})

            def do_DELETE(self):
                if self._authenticate() is None:
                    return
                parts = [p for p in self.path.split("/") if p]
                if parts[:2] == ["v1", "statement"] and len(parts) == 3:
                    ok = outer.manager.cancel(parts[2])
                    self._send(200 if ok else 404, {"canceled": ok})
                    return
                self._send(404, {"error": "not found"})

            def do_PUT(self):
                if self.path == "/v1/info/state":
                    body = self._read_body().decode().strip().strip('"')
                    # shutdown is privileged: authenticate first (body is
                    # already drained so a 401 leaves the stream clean)
                    if self._authenticate() is None:
                        return
                    if body == "SHUTTING_DOWN":
                        outer.shutting_down = True  # drain: reject new queries
                        self._send(200, {"state": "SHUTTING_DOWN"})
                        return
                self._send(404, {"error": "not found"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if tls is not None:
            from .auth import server_ssl_context

            certfile, keyfile = tls
            self._httpd.socket = server_ssl_context(
                certfile, keyfile
            ).wrap_socket(self._httpd.socket, server_side=True)
        self.host, self.port = self._httpd.server_address
        self.scheme = "https" if tls is not None else "http"
        if self.syscat is not None:
            self.syscat.self_uri = f"{self.scheme}://{self.host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    # -- web UI (reference: presto-main webapp/ React query list; here a
    # dependency-free server-rendered page off the same QueryManager) --

    def _render_ui(self) -> str:
        import html

        rows = []
        for info in sorted(
            self.manager.list_queries(),
            key=lambda i: i.created_at, reverse=True,
        )[:50]:
            elapsed = (info.finished_at or time.time()) - info.created_at
            q = html.escape(info.sql.replace("\n", " ")[:120])
            err = html.escape((info.error or "").strip().split("\n")[-1][:120])
            rows.append(
                f"<tr class='{info.state.lower()}'>"
                f"<td><a href='/query/{info.query_id}'>{info.query_id}</a>"
                f"</td>"
                f"<td>{info.state}</td><td>{html.escape(info.user)}</td>"
                f"<td>{elapsed:.2f}s</td><td><code>{q}</code>"
                f"{'<br><small>' + err + '</small>' if err else ''}</td></tr>"
            )
        groups = "".join(
            f"<tr><td>{s.name}</td><td>{s.running}</td><td>{s.queued}</td>"
            f"<td>{s.cpu_used_s:.2f}s</td></tr>"
            for s in self.manager.groups.stats()
        )
        return f"""<!doctype html><html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="5"><title>presto-tpu</title><style>
body{{font-family:system-ui,sans-serif;margin:2em;background:#fafafa}}
table{{border-collapse:collapse;width:100%;margin-bottom:2em;background:#fff}}
td,th{{border:1px solid #ddd;padding:6px 10px;text-align:left;font-size:14px}}
th{{background:#2b3a4a;color:#fff}} .failed td{{background:#fde8e8}}
.running td{{background:#e8f4fd}} .finished td{{background:#f2fdf2}}
code{{font-size:12px}}</style></head><body>
<h1>presto-tpu coordinator</h1>
<p>{VERSION} &middot; uptime {time.time() - self.started_at:.0f}s &middot;
state {"SHUTTING_DOWN" if self.shutting_down else "ACTIVE"}</p>
<h2>Queries</h2>
<table><tr><th>id</th><th>state</th><th>user</th><th>elapsed</th>
<th>query</th></tr>{''.join(rows)}</table>
<h2>Resource groups</h2>
<table><tr><th>group</th><th>running</th><th>queued</th><th>cpu used</th></tr>
{groups}</table></body></html>"""

    def _render_query_detail(self, query_id: str) -> Optional[str]:
        """Per-query page: SQL, state, plan tree, error (reference webapp
        query.html/plan.html views, server-rendered)."""
        import html

        info = self.manager.get(query_id)
        if info is None:
            return None
        if info.plan is None and info.error is None:
            try:  # same lazy render as the /v1/query/{id} endpoint
                info.plan = self.manager.session.explain(info.sql)
            except Exception:  # noqa: BLE001 - plan render is advisory
                pass
        elapsed = (info.finished_at or time.time()) - info.created_at
        plan = html.escape(info.plan or "(plan not recorded)")
        err = (
            f"<h2>Error</h2><pre class='err'>{html.escape(info.error)}</pre>"
            if info.error
            else ""
        )
        # LIVE view (reference webapp query.html auto-updates): running
        # queries re-render every 2s until terminal
        live = (
            "" if info.done
            else '<meta http-equiv="refresh" content="2">'
        )
        stages = self._render_stages(info)
        return f"""<!doctype html><html><head><meta charset="utf-8">{live}
<title>{query_id}</title><style>
body{{font-family:system-ui,sans-serif;margin:2em;background:#fafafa}}
pre{{background:#fff;border:1px solid #ddd;padding:1em;overflow:auto;
font-size:13px}} .err{{background:#fde8e8}}
.meta td{{padding:4px 12px 4px 0}}</style></head><body>
<p><a href="/">&larr; queries</a></p>
<h1>{query_id}</h1>
<table class="meta">
<tr><td>state</td><td><b>{info.state}</b></td></tr>
<tr><td>user</td><td>{html.escape(info.user)}</td></tr>
<tr><td>elapsed</td><td>{elapsed:.2f}s</td></tr>
</table>
<h2>SQL</h2><pre>{html.escape(info.sql)}</pre>
<h2>Plan</h2><pre>{plan}</pre>
{stages}
{err}</body></html>"""

    def _render_stages(self, info) -> str:
        """Stage breakdown (reference webapp stage.html): the FRAGMENTED
        plan with one section per stage when the session is distributed;
        single-stage note otherwise."""
        import html

        sess = self.manager.session
        if getattr(sess, "mesh", None) is None:
            return (
                "<h2>Stages</h2><p>single stage (one-process session; "
                "pass a mesh for fragmented execution)</p>"
            )
        # render once per query and cache on the QueryInfo: the live page
        # refreshes every 2s and must not re-plan each time (and the plan
        # at SUBMIT time is the one that executed)
        cached = getattr(info, "stages_html", None)
        if cached is None:
            try:
                node = sess.plan(info.sql)
                from ..plan import nodes as N

                txt = html.escape(N.plan_tree_str(node))
            except Exception as e:  # noqa: BLE001 - advisory view
                txt = html.escape(f"(stage render failed: {e})")
            cached = f"<h2>Stages (fragmented)</h2><pre>{txt}</pre>"
            try:
                info.stages_html = cached
            except AttributeError:
                pass  # frozen dataclass: render per view
        return cached

    def _render_timeline(self) -> str:
        """Query lifecycle timeline (reference webapp timeline.html): an
        SVG gantt of the most recent queries — queued span (created ->
        started) and execution span (started -> finished/now), refreshed
        live every 2s."""
        import html

        infos = sorted(
            self.manager.list_queries(),
            key=lambda q: q.created_at,
        )[-30:]
        now = time.time()
        if infos:
            t0 = min(q.created_at for q in infos)
            t1 = max((q.finished_at or now) for q in infos)
        else:
            t0, t1 = now - 1, now
        span = max(t1 - t0, 1e-3)
        W, ROW = 900, 22
        bars = []
        for i, q in enumerate(infos):
            y = i * ROW
            qs = (q.created_at - t0) / span * W
            xs = ((q.started_at or q.created_at) - t0) / span * W
            xe = ((q.finished_at or now) - t0) / span * W
            color = {
                "FINISHED": "#2e7d32", "FAILED": "#c62828",
                "RUNNING": "#1565c0",
            }.get(q.state, "#999")
            label = html.escape(q.sql.replace("\n", " ")[:60])
            bars.append(
                f'<rect x="{qs:.1f}" y="{y + 4}" '
                f'width="{max(xs - qs, 1):.1f}" height="12" fill="#ccc"/>'
                f'<rect x="{xs:.1f}" y="{y + 4}" '
                f'width="{max(xe - xs, 1):.1f}" height="12" '
                f'fill="{color}"><title>{label}</title></rect>'
                f'<text x="{min(xe + 4, W - 150):.1f}" y="{y + 14}" '
                f'font-size="10">'
                f'<a href="/query/{q.query_id}">{q.query_id}</a></text>'
            )
        h = max(len(infos) * ROW + 10, 40)
        return f"""<!doctype html><html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="2"><title>timeline</title>
<style>body{{font-family:system-ui,sans-serif;margin:2em}}</style>
</head><body><p><a href="/">&larr; queries</a></p>
<h1>Query timeline</h1>
<p>grey = queued, colored = executing (green finished / red failed /
blue running)</p>
<svg width="{W + 160}" height="{h}">{''.join(bars)}</svg>
</body></html>"""

    # -- protocol payloads --

    def _query_summary(self, info) -> dict:
        return {
            "queryId": info.query_id,
            "state": info.state,
            "query": info.sql,
            "elapsed_s": round(
                (info.finished_at or time.time()) - info.created_at, 3
            ),
        }

    def _query_results(self, info, token: int) -> dict:
        base = f"{self.scheme}://{self.host}:{self.port}"
        out = {
            "id": info.query_id,
            "infoUri": f"{base}/v1/query/{info.query_id}",
            "stats": {"state": info.state},
        }
        if info.state == FINISHED and info.rows is not None:
            out["columns"] = info.columns
            start = token * PAGE_ROWS
            chunk = info.rows[start : start + PAGE_ROWS]
            out["data"] = [list(r) for r in chunk]
            if start + PAGE_ROWS < len(info.rows):
                out["nextUri"] = (
                    f"{base}/v1/statement/{info.query_id}/{token + 1}"
                )
        elif info.done:
            out["error"] = {"message": info.error or info.state}
        else:
            out["nextUri"] = f"{base}/v1/statement/{info.query_id}/{token}"
        return out

    # -- lifecycle --

    def start(self) -> "CoordinatorServer":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def uri(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"
