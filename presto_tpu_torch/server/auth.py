"""Authentication for the coordinator (torch counterpart of
presto_tpu/server/auth.py).

Re-designed equivalent of the reference's presto-password-authenticators
(470 LoC: FileAuthenticator over a password db, the PasswordAuthenticator
SPI in presto-spi/security) and the coordinator's HTTPS listener
(presto-docs security/tls.rst). Identity flow matches the reference:
with an authenticator installed the HTTP principal comes from Basic
credentials and the session user must match it: a bare X-Presto-User
header is not trusted."""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import os
import secrets
import ssl
import subprocess
from typing import Dict, Optional, Tuple


class AuthenticationError(RuntimeError):
    """Reference: AccessDeniedException from an authenticator."""


class PasswordAuthenticator:
    """SPI (reference spi/security/PasswordAuthenticator): return the
    authenticated principal for (user, password) or raise."""

    def authenticate(self, user: str, password: str) -> str:
        raise NotImplementedError


_ITERATIONS = 50_000


def hash_password(password: str, salt: Optional[bytes] = None) -> str:
    """salt$hex(pbkdf2-sha256) — the stored credential form."""
    salt = salt or secrets.token_bytes(16)
    digest = hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, _ITERATIONS
    )
    return f"{salt.hex()}${digest.hex()}"


class FilePasswordAuthenticator(PasswordAuthenticator):
    """`path`: lines of `user:salt$pbkdf2hex` (reference file-based
    password authenticator; htpasswd-style)."""

    def __init__(self, path: str):
        self.creds: Dict[str, str] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or ":" not in line:
                    continue
                user, stored = line.split(":", 1)
                self.creds[user] = stored

    @staticmethod
    def write(path: str, users: Dict[str, str]) -> None:
        with open(path, "w") as f:
            for user, password in users.items():
                f.write(f"{user}:{hash_password(password)}\n")
        os.chmod(path, 0o600)

    def authenticate(self, user: str, password: str) -> str:
        stored = self.creds.get(user)
        if stored is None or "$" not in stored:
            raise AuthenticationError("invalid credentials")
        salt_hex, want_hex = stored.split("$", 1)
        try:
            salt = bytes.fromhex(salt_hex)
            want = bytes.fromhex(want_hex)
        except ValueError:
            raise AuthenticationError("invalid credentials") from None
        got = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt, _ITERATIONS
        )
        if not hmac.compare_digest(got, want):
            raise AuthenticationError("invalid credentials")
        return user


def parse_basic_auth(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """Authorization: Basic base64(user:password) -> (user, password)."""
    if not header or not header.startswith("Basic "):
        return None
    try:
        decoded = base64.b64decode(header[len("Basic "):]).decode()
    except (binascii.Error, UnicodeDecodeError):
        return None
    if ":" not in decoded:
        return None
    user, password = decoded.split(":", 1)
    return user, password


def basic_auth_header(user: str, password: str) -> str:
    return "Basic " + base64.b64encode(
        f"{user}:{password}".encode()
    ).decode()


# -- TLS ---------------------------------------------------------------------


def generate_self_signed_cert(directory: str, cn: str = "localhost"):
    """(certfile, keyfile) under `directory` — openssl-generated
    self-signed pair for tests/dev (production supplies real certs)."""
    cert = os.path.join(directory, "server.crt")
    key = os.path.join(directory, "server.key")
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", key, "-out", cert, "-days", "2", "-nodes",
            "-subj", f"/CN={cn}",
            "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1",
        ],
        check=True,
        capture_output=True,
    )
    return cert, key


def server_ssl_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


def client_ssl_context(cafile: Optional[str] = None) -> ssl.SSLContext:
    """Verifying client context; `cafile` pins a self-signed server."""
    ctx = ssl.create_default_context(cafile=cafile)
    return ctx
