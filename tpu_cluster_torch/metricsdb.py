"""A metrics registry behind a daemon-threaded ``/metrics`` endpoint: the
``MetricsServer`` of ``tpu_cluster/metricsdb.py``, the port's own copy.
The scrape/TSDB side is not ported."""

from __future__ import annotations

import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List

from . import telemetry as _telemetry


class MetricsServer:
    """Expose one ``MetricsRegistry`` over HTTP (``/metrics``,
    exposition content type) from a daemon thread — what makes a
    serving replica a scrape target. Construction BINDS: a port conflict
    raises OSError immediately so the caller can apply its own policy."""

    def __init__(self, registry: _telemetry.MetricsRegistry, port: int,
                 host: str = "127.0.0.1") -> None:
        self.registry = registry
        # Live handler connections, severed by stop(): shutdown() only
        # stops the LISTENER — an established keep-alive handler thread
        # would keep serving the registry to a connected scraper after
        # "stop". Leaf lock, never nested.
        self._conns: List[Any] = []  # guarded-by: _conns_lock
        self._conns_lock: Any = threading.Lock()

        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self) -> None:
                super().setup()
                with server_ref._conns_lock:
                    server_ref._conns.append(self.connection)

            def finish(self) -> None:
                try:
                    super().finish()
                finally:
                    with server_ref._conns_lock:
                        try:
                            server_ref._conns.remove(self.connection)
                        except ValueError:
                            pass

            def log_message(self, *args: Any) -> None:
                pass

            def do_GET(self) -> None:
                if self.path.partition("?")[0] != "/metrics":
                    body = b"try /metrics\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                body = server_ref.registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"metrics-server-{self.port}")

    @property
    def port(self) -> int:
        return int(self._server.server_address[1])

    @property
    def url(self) -> str:
        host = str(self._server.server_address[0])
        return f"http://{host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        # sever established keep-alive handlers: a scraper's parked
        # connection must die with the server, not keep being answered
        # by a zombie handler thread (see _conns)
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._server.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

