"""The rendezvous HTTP KV store of the port's launcher — its copy of
``horovod_tpu/runner/rendezvous.py``. The data plane does not need it
(``torch.distributed`` meets on the coordinator's TCPStore); the elastic
driver and its workers do: the topology version the workers poll at
``commit()``.

Protocol: ``PUT /kv/<scope>/<key>`` (body = the value; ``?nx=1`` is a
put-if-absent, 409 with the stored value to the loser), ``GET`` returns
200 and the value or 404, ``DELETE`` removes, ``GET /kv/<scope>?list=1``
the JSON key list.

Authentication: a request may carry ``X-HVD-Auth: HMAC-SHA256(secret,
method|path?query|body)``, the JAX package's digest; a server with a
secret (argument or ``HVD_TPU_RENDEZVOUS_SECRET``) answers 403 to a
missing or wrong one. The elastic driver makes a fresh secret a job and
hands it to its workers through their environment.

The client retries connection errors, timeouts and 5xx with full-jitter
backoff (``faults.Backoff``; ``HVD_TPU_RENDEZVOUS_RETRIES``,
``HVD_TPU_RENDEZVOUS_BACKOFF_{BASE_S,MAX_S}``); the ``rendezvous``
fault site fires once an attempt.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..common.config import runtime_env
from ..common.httpd import BackgroundHTTPServer

logger = logging.getLogger("horovod_tpu_torch")

_AUTH_HEADER = "X-HVD-Auth"


def _env_secret() -> Optional[bytes]:
    s = runtime_env("RENDEZVOUS_SECRET", "")
    return s.encode() if s else None


def _digest(secret: bytes, method: str, path_qs: str,
            body: bytes) -> str:
    mac = hmac.new(secret, digestmod=hashlib.sha256)
    mac.update(method.encode())
    mac.update(b"|")
    mac.update(path_qs.encode())
    mac.update(b"|")
    mac.update(body)
    return mac.hexdigest()


class _Handler(BaseHTTPRequestHandler):
    server_version = "HvdTpuRendezvous/0.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _store(self) -> Dict[str, bytes]:
        return self.server.kv_store  # type: ignore[attr-defined]

    def _lock(self) -> threading.Lock:
        return self.server.kv_lock  # type: ignore[attr-defined]

    def _authorized(self, body: bytes = b"") -> bool:
        secret = self.server.kv_secret  # type: ignore[attr-defined]
        if secret is None:
            return True
        given = self.headers.get(_AUTH_HEADER, "")
        want = _digest(secret, self.command, self.path, body)
        if hmac.compare_digest(given, want):
            return True
        self.send_response(403)
        self.end_headers()
        return False

    def do_PUT(self):
        parsed = urlparse(self.path)
        path = parsed.path
        nx = bool(parse_qs(parsed.query).get("nx"))
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._authorized(body):
            return
        with self._lock():
            if nx and path in self._store():
                # Atomic put-if-absent: first writer wins; the loser gets
                # the stored value back (409) so concurrent publishers
                # converge on one value (the retried-task-0 case).
                val = self._store()[path]
                self.send_response(409)
                self.send_header("Content-Length", str(len(val)))
                self.end_headers()
                self.wfile.write(val)
                return
            self._store()[path] = body
        self.send_response(200)
        self.end_headers()

    def do_GET(self):
        if not self._authorized():
            return
        parsed = urlparse(self.path)
        qs = parse_qs(parsed.query)
        with self._lock():
            if qs.get("list"):
                prefix = parsed.path.rstrip("/") + "/"
                keys = [k[len(prefix):] for k in self._store()
                        if k.startswith(prefix)]
                data = json.dumps(sorted(keys)).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            val = self._store().get(parsed.path)
        if val is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_DELETE(self):
        if not self._authorized():
            return
        path = urlparse(self.path).path
        with self._lock():
            existed = self._store().pop(path, None) is not None
        self.send_response(200 if existed else 404)
        self.end_headers()


class RendezvousServer:
    """The KV server: ``start()`` on an ephemeral port (returned),
    ``stop()``, and direct in-process ``put``/``get`` for the driver."""

    def __init__(self, host: str = "0.0.0.0",
                 secret: Optional[bytes] = None):
        self._secret = secret if secret is not None else _env_secret()
        self._http = BackgroundHTTPServer(_Handler, host=host)

    def start(self, port: int = 0) -> int:
        return self._http.start(port, kv_store={},
                                kv_lock=threading.Lock(),
                                kv_secret=self._secret)

    @property
    def port(self) -> int:
        return self._http.port

    def stop(self) -> None:
        self._http.stop()

    # Direct (in-process) access for the driver side.
    def put(self, scope: str, key: str, value: bytes) -> None:
        srv = self._http.server
        with srv.kv_lock:  # type: ignore[attr-defined]
            srv.kv_store[f"/kv/{scope}/{key}"] = value  # type: ignore

    def get(self, scope: str, key: str) -> Optional[bytes]:
        srv = self._http.server
        with srv.kv_lock:  # type: ignore[attr-defined]
            return srv.kv_store.get(f"/kv/{scope}/{key}")  # type: ignore

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        """All (key, value) pairs under a scope (driver side)."""
        srv = self._http.server
        prefix = f"/kv/{scope}/"
        with srv.kv_lock:  # type: ignore[attr-defined]
            return {k[len(prefix):]: v
                    for k, v in srv.kv_store.items()  # type: ignore
                    if k.startswith(prefix)}


class RendezvousClient:
    """The worker-side client. Signs every request when a secret is
    configured (argument or HVD_TPU_RENDEZVOUS_SECRET).

    Every request retries transient failures — connection errors,
    timeouts, HTTP 5xx — with exponential full-jitter backoff
    (``retries`` attempts beyond the first; knobs
    ``HVD_TPU_RENDEZVOUS_RETRIES`` /
    ``HVD_TPU_RENDEZVOUS_BACKOFF_{BASE_S,MAX_S}``). 4xx responses
    (404 absent key, 403 auth, 409 put-if-absent conflict) carry
    protocol meaning and surface immediately."""

    def __init__(self, addr: str, port: int, timeout_s: float = 30.0,
                 secret: Optional[bytes] = None,
                 retries: Optional[int] = None):
        self.base = f"http://{addr}:{port}"
        self.timeout_s = timeout_s
        self._secret = secret if secret is not None else _env_secret()
        if retries is None:
            try:
                retries = int(runtime_env("RENDEZVOUS_RETRIES", "4"))
            except ValueError:
                retries = 4
        self.retries = max(0, retries)

    def _backoff(self):
        from ..common import faults as faults_lib

        return faults_lib.Backoff.from_env(
            "HVD_TPU_RENDEZVOUS_BACKOFF", base_s=0.1, cap_s=2.0)

    def _request(self, path_qs: str, method: str,
                 data: Optional[bytes] = None):
        import urllib.error
        import urllib.request

        from ..common import faults as faults_lib

        backoff = self._backoff()
        attempt = 0
        while True:
            try:
                # Chaos site: per-attempt, so an injected 5xx/drop is
                # absorbed by this very retry loop.
                faults_lib.maybe_rendezvous_fault()
                req = urllib.request.Request(self.base + path_qs,
                                             data=data, method=method)
                if self._secret is not None:
                    req.add_header(_AUTH_HEADER,
                                   _digest(self._secret, method, path_qs,
                                           data or b""))
                return urllib.request.urlopen(req,
                                              timeout=self.timeout_s)
            except urllib.error.HTTPError as e:
                # 4xx is protocol semantics; only server-side errors are
                # retryable.
                if e.code < 500 or attempt >= self.retries:
                    raise
                err = e
            except (urllib.error.URLError, ConnectionError,
                    TimeoutError, OSError) as e:
                if attempt >= self.retries:
                    raise
                err = e
            attempt += 1
            faults_lib.stats.bump("rendezvous_retries")
            logger.debug(
                "rendezvous: %s %s failed (%s); retry %d/%d",
                method, path_qs, err, attempt, self.retries)
            backoff.sleep()

    def put(self, scope: str, key: str, value: bytes) -> None:
        self._request(f"/kv/{scope}/{key}", "PUT", value).read()

    def put_if_absent(self, scope: str, key: str, value: bytes) -> bytes:
        """Atomic first-writer-wins PUT; returns the WINNING value (the
        caller's on success, the already-stored one on conflict)."""
        import urllib.error

        try:
            self._request(f"/kv/{scope}/{key}?nx=1", "PUT", value).read()
            return value
        except urllib.error.HTTPError as e:
            if e.code == 409:
                return e.read()
            raise

    def get(self, scope: str, key: str) -> Optional[bytes]:
        import urllib.error

        try:
            return self._request(f"/kv/{scope}/{key}", "GET").read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def wait(self, scope: str, key: str,
             timeout_s: float = 60.0) -> bytes:
        """Poll until the key exists. Polling backs off exponentially
        (full jitter, capped at ``HVD_TPU_RENDEZVOUS_WAIT_MAX_POLL_S``,
        default 1 s) — N workers hot-polling a slow coordinator at 50 ms
        is a self-inflicted thundering herd."""
        import time

        from ..common import faults as faults_lib

        try:
            cap = float(runtime_env("RENDEZVOUS_WAIT_MAX_POLL_S", "1.0"))
        except ValueError:
            cap = 1.0
        backoff = faults_lib.Backoff(base_s=0.05, cap_s=cap)
        deadline = time.monotonic() + timeout_s
        while True:
            val = self.get(scope, key)
            if val is not None:
                return val
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(f"rendezvous key {scope}/{key} not set "
                                   f"within {timeout_s}s")
            # Never jitter past the caller's deadline (plus a floor so a
            # nearly-expired wait still yields the CPU).
            time.sleep(min(max(backoff.next_delay(), 0.005),
                           max(deadline - now, 0.01)))

    def list(self, scope: str) -> list:
        return json.loads(self._request(f"/kv/{scope}?list=1",
                                        "GET").read())

    def delete(self, scope: str, key: str) -> None:
        import urllib.error

        try:
            self._request(f"/kv/{scope}/{key}", "DELETE").read()
        except urllib.error.HTTPError as e:
            if e.code != 404:  # 403 etc. must surface, only absent is ok
                raise
