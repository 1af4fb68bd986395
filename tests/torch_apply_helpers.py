"""Shared pieces of the port's apply-path tests (``test_torch_kubeapply``,
``test_torch_telemetry``, ``test_torch_events``): the wire recorder and
a fixture that turns Nagle's algorithm off on the fake apiserver's
connections. The fake writes a reply's headers and body in two sends;
with Nagle on, the body waits for the client's delayed ACK (about 40 ms
a request on some kernels). Turning it off changes no byte on the
wire."""

import http.client
import re
import socketserver

import pytest

_TRACEPARENT = re.compile(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01")


@pytest.fixture(autouse=True)
def no_nagle(monkeypatch):
    monkeypatch.setattr(socketserver.StreamRequestHandler,
                        "disable_nagle_algorithm", True)


def mask_traceparents(text):
    return _TRACEPARENT.sub("TRACEPARENT", text)


class Wire:
    """Every request a client sends through ``http.client`` (both engines'
    default keep-alive transport): method, URL, body with W3C traceparent
    ids masked, Content-Type.

    No lock: ``list.append`` is atomic, and the suite's lock-order monitor
    would see a lock taken here under the client's SSA probe lock as a
    new edge. ``take`` runs once the client is closed."""

    def __init__(self, monkeypatch):
        self._log = []
        orig = http.client.HTTPConnection.request
        log = self._log

        def request(conn, method, url, body=None, headers=None, **kw):
            text = body.decode() if isinstance(body, bytes) else body or ""
            ctype = (headers or {}).get("Content-Type", "")
            log.append((method, url, mask_traceparents(text), ctype))
            return orig(conn, method, url, body=body, headers=headers or {},
                        **kw)

        monkeypatch.setattr(http.client.HTTPConnection, "request", request)

    def take(self):
        out = list(self._log)
        del self._log[:]
        return out
