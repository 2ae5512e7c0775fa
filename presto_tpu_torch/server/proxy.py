"""Coordinator proxy (torch counterpart of presto_tpu/server/proxy.py).

Re-designed equivalent of presto-proxy (893 LoC: a Jetty forwarder that
authenticates clients, signs/forwards requests to the real coordinator,
and rewrites response URIs so clients keep talking to the proxy). Same
contract here over stdlib HTTP: the proxy terminates client auth (its
own password file), then forwards upstream with the proxy's backend
credentials — clients never hold coordinator credentials — and rewrites
every nextUri/infoUri in responses to point at itself."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class ProxyServer:
    def __init__(
        self,
        backend_uri: str,
        host: str = "127.0.0.1",
        port: int = 0,
        authenticator=None,
        backend_user: Optional[str] = None,
        backend_password: Optional[str] = None,
        backend_cafile: Optional[str] = None,
    ):
        self.backend = backend_uri.rstrip("/")
        self.authenticator = authenticator
        self._backend_auth = None
        if backend_user is not None:
            from .auth import basic_auth_header

            self._backend_auth = basic_auth_header(
                backend_user, backend_password or ""
            )
        self._ssl_ctx = None
        if self.backend.startswith("https"):
            from .auth import client_ssl_context

            self._ssl_ctx = client_ssl_context(backend_cafile)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _reject(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                if code == 401:
                    self.send_header(
                        "WWW-Authenticate", 'Basic realm="presto-proxy"'
                    )
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _client_principal(self):
                """Authenticated client identity, or None after a 401;
                (None, True) means auth is disabled."""
                if outer.authenticator is None:
                    return self.headers.get("X-Presto-User"), True
                from .auth import AuthenticationError, parse_basic_auth

                creds = parse_basic_auth(self.headers.get("Authorization"))
                if creds is None:
                    self._reject(401, {"error": "credentials required"})
                    return None, False
                try:
                    return outer.authenticator.authenticate(*creds), True
                except AuthenticationError as e:
                    self._reject(401, {"error": str(e)})
                    return None, False

            def _forward(self, method: str):
                principal, ok = self._client_principal()
                if not ok:
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else None
                req = urllib.request.Request(
                    outer.backend + self.path, data=body, method=method
                )
                for h in ("X-Presto-Session", "X-Presto-Source"):
                    v = self.headers.get(h)
                    if v:
                        req.add_header(h, v)
                # the PROXY-authenticated identity is what flows upstream
                # (the coordinator authorizes the backend principal to
                # impersonate via impersonation_principals) — never the
                # client's self-asserted header
                if principal:
                    req.add_header("X-Presto-User", principal)
                if outer._backend_auth:
                    req.add_header("Authorization", outer._backend_auth)
                try:
                    with urllib.request.urlopen(
                        req, timeout=60, context=outer._ssl_ctx
                    ) as resp:
                        payload = resp.read()
                        code = resp.status
                        ctype = resp.headers.get(
                            "Content-Type", "application/json"
                        )
                except urllib.error.HTTPError as e:
                    payload = e.read()
                    code = e.code
                    ctype = e.headers.get("Content-Type", "application/json")
                except urllib.error.URLError as e:
                    self._reject(
                        502, {"error": f"backend unreachable: {e.reason}"}
                    )
                    return
                payload = outer._rewrite(payload)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._forward("GET")

            def do_POST(self):
                self._forward("POST")

            def do_DELETE(self):
                self._forward("DELETE")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def _rewrite(self, payload: bytes) -> bytes:
        """Point response URIs (nextUri etc.) back at the proxy so the
        client's whole conversation stays on this listener."""
        try:
            doc = json.loads(payload)
        except (ValueError, UnicodeDecodeError):
            return payload
        me = f"http://{self.host}:{self.port}"

        def walk(v):
            if isinstance(v, dict):
                return {k: walk(x) for k, x in v.items()}
            if isinstance(v, list):
                return [walk(x) for x in v]
            if isinstance(v, str) and v.startswith(self.backend):
                return me + v[len(self.backend):]
            return v

        return json.dumps(walk(doc)).encode()

    def start(self) -> "ProxyServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def uri(self) -> str:
        return f"http://{self.host}:{self.port}"
