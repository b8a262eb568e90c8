"""Shared background ``ThreadingHTTPServer`` plumbing — the port's copy
of ``horovod_tpu/common/httpd.py``.

Three subsystems serve stdlib HTTP from a daemon thread: the rendezvous
KV server (``runner/rendezvous.py``), the per-rank ``/metrics``
endpoint (``common/metrics.py``) and the elastic driver's
``/pod/metrics`` aggregator (``common/podmon.py``). They share one
lifecycle — bind (possibly an ephemeral port), ``serve_forever`` on a
daemon thread, shutdown and close on stop — so it lives here once.
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer
from typing import Optional


class BackgroundHTTPServer:
    """A ThreadingHTTPServer on a daemon thread.

    ``start(port, **attrs)`` sets each of ``attrs`` on the server
    instance BEFORE the first request can arrive — the stdlib handler
    model passes per-server state through attributes (the rendezvous
    KV store/lock/secret; the metrics registry; the pod monitor)."""

    def __init__(self, handler_cls, host: str = "0.0.0.0"):
        self._handler_cls = handler_cls
        self._host = host
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, port: int = 0, **attrs) -> int:
        """Bind and serve; returns the bound port (``port=0`` =
        ephemeral)."""
        self._server = ThreadingHTTPServer((self._host, port),
                                           self._handler_cls)
        for k, v in attrs.items():
            setattr(self._server, k, v)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._server.server_address[1]

    @property
    def server(self) -> ThreadingHTTPServer:
        assert self._server is not None
        return self._server

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    @property
    def running(self) -> bool:
        return self._server is not None

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None
