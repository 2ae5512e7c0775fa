"""Python client for the coordinator's statement protocol (torch
counterpart of presto_tpu/server/client.py).

Re-designed equivalent of the reference's client library
(presto-client/.../StatementClientV1.java + QueryResults nextUri paging,
presto-cli's transport): POST the statement, follow nextUri until the
terminal state, yield rows. stdlib urllib — no dependencies."""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Iterator, List, Optional, Tuple


class QueryError(RuntimeError):
    pass


class Client:
    def __init__(self, server_uri: str, timeout: float = 30.0,
                 user: Optional[str] = None, password: Optional[str] = None,
                 cafile: Optional[str] = None,
                 max_retries: int = 8, backoff_base: float = 0.05,
                 backoff_cap: float = 2.0):
        """user/password: Basic credentials for an authenticating
        coordinator; cafile: CA bundle pinning an https coordinator
        (reference StatementClient auth + OkHttp TLS setup).

        max_retries / backoff_base / backoff_cap bound the capped
        exponential backoff applied to `503 {"retry": true}` responses
        (a worker/coordinator saying "not ready yet, poll again" —
        server/worker.py results long-poll); a transient connection
        reset is additionally retried once."""
        self.server = server_uri.rstrip("/")
        self.timeout = timeout
        self.user = user
        self.password = password
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._ssl_ctx = None
        if self.server.startswith("https"):
            from .auth import client_ssl_context

            self._ssl_ctx = client_ssl_context(cafile)

    def _request(self, method: str, url: str, body: Optional[bytes] = None):
        import urllib.error

        retries = 0
        transient_retried = False
        while True:
            req = urllib.request.Request(url, data=body, method=method)
            if self.user is not None and self.password is not None:
                from .auth import basic_auth_header

                req.add_header(
                    "Authorization",
                    basic_auth_header(self.user, self.password),
                )
            try:
                with urllib.request.urlopen(
                    req, timeout=self.timeout, context=self._ssl_ctx
                ) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                # coordinator errors carry JSON bodies (404 unknown query,
                # 503 draining) — surface them as QueryError, not HTTPError
                try:
                    payload = json.loads(e.read())
                except Exception:  # noqa: BLE001 — a non-JSON error body
                    # becomes the QueryError message itself
                    payload = {"error": str(e)}
                if (
                    e.code == 503
                    and isinstance(payload, dict)
                    and payload.get("retry")
                    and retries < self.max_retries
                ):
                    # "not ready yet" — NOT an error: back off and repoll
                    time.sleep(
                        min(self.backoff_base * (2 ** retries),
                            self.backoff_cap)
                    )
                    retries += 1
                    continue
                if isinstance(payload, dict) and "canceled" in payload:
                    return payload
                raise QueryError(
                    f"{e.code}: {payload.get('error', payload)}"
                ) from None
            except (ConnectionResetError, urllib.error.URLError) as e:
                # one transient-network retry (reference OkHttp
                # retryOnConnectionFailure): a coordinator restarting its
                # accept loop or a dropped keep-alive connection. A POST
                # is only re-sent when the connection was REFUSED (no
                # bytes reached the server) — a reset mid-exchange could
                # mean the statement was already accepted, and a blind
                # re-send would execute the query twice.
                refused = isinstance(
                    getattr(e, "reason", e), ConnectionRefusedError
                )
                idempotent = method in ("GET", "DELETE", "HEAD", "PUT")
                if not transient_retried and (idempotent or refused):
                    transient_retried = True
                    time.sleep(self.backoff_base)
                    continue
                raise QueryError(f"connection failed: {e}") from None

    def execute(self, sql: str) -> Tuple[List[dict], List[list]]:
        """Run to completion; returns (columns, rows)."""
        cols: List[dict] = []
        rows: List[list] = []
        payload = self._request(
            "POST", f"{self.server}/v1/statement", sql.encode()
        )
        while True:
            if "error" in payload:
                raise QueryError(str(payload["error"].get("message")))
            if payload.get("columns"):
                cols = payload["columns"]
            rows.extend(payload.get("data", []))
            nxt = payload.get("nextUri")
            if nxt is None:
                return cols, rows
            payload = self._request("GET", nxt + "?maxWait=5")

    def cancel(self, query_id: str) -> bool:
        out = self._request(
            "DELETE", f"{self.server}/v1/statement/{query_id}"
        )
        return bool(out.get("canceled"))

    def queries(self) -> List[dict]:
        return self._request("GET", f"{self.server}/v1/query")

    def node_info(self) -> dict:
        return self._request("GET", f"{self.server}/v1/info")
