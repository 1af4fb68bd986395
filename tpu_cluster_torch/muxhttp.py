"""Multiplexed HTTP/1.1 transport: one shared asyncio event loop driving
a BOUNDED pool of persistent connections for every worker thread
(the fleet-scale apply half). The port's own copy of
``tpu_cluster/muxhttp.py``.

Why this exists: the keep-alive transport the pipelined engine uses
holds ONE socket per worker thread (``Client._connection`` is
thread-local) — at ``--max-inflight 8`` that is 8 sockets, but the
socket count scales with the thread count, and a fleet-scale rollout
driving wider pools (or many concurrent controllers) pays a socket + FD
per thread per client. Real control-plane clients multiplex instead:
requests from every caller funnel through a small shared connection
pool (HTTP/2 streams, or a bounded HTTP/1.1 pool), so the socket count
is O(pool), not O(threads).

This module is the stdlib-only version of that shape: a daemon thread
runs one asyncio event loop; :meth:`MuxTransport.request` is the
thread-safe blocking seam (``run_coroutine_threadsafe``) the Client's
``_request_mux`` calls; inside the loop, requests acquire a connection
from an idle pool bounded at ``pool_size`` (excess requests QUEUE on
the pool rather than opening sockets), speak plain HTTP/1.1
(Content-Length and chunked framing both decoded), and return the
connection for the next request. The whole attempt is bounded by the
caller's wall via ``asyncio.wait_for`` — a stalled or trickling server
cancels the coroutine and the connection is discarded, the same
whole-attempt-deadline contract as the thread transports.

Concurrency model: ALL pool state (open-connection count, idle queue,
socket stats) is touched only on the loop thread — no locks at all.
The only cross-thread surfaces are ``run_coroutine_threadsafe`` (whose
synchronization belongs to asyncio) and the read-only stats ints tests
read after the fact.

Off by default: ``kubeapply.Client`` builds a MuxTransport only when
``mux=N`` is set, so the default transport path is byte-identical to
the pre-fleet client.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import ssl
import threading
import urllib.parse
from typing import Dict, List, Optional, Tuple


class MuxError(Exception):
    """Transport failure inside the multiplexed transport. ``cause``
    carries the underlying exception so the client's status-0
    classification preserves the exception class (the
    ``_transport_error`` contract)."""

    def __init__(self, cause: BaseException) -> None:
        super().__init__(f"{type(cause).__name__}: {cause}")
        self.cause = cause


class MuxStale(MuxError):
    """A REUSED pooled connection died before ANY response byte arrived:
    the server closed it while idle. The request may never have been
    seen, so one immediate retry on a fresh connection is safe — the
    twin of the keep-alive transport's stale-socket fast retry."""


class MuxDeadline(Exception):
    """The whole-attempt wall cut the request mid-flight (stall or
    trickle); classifies as the AttemptDeadline status-0 family."""


class _Conn:
    """One pooled connection (loop-thread-owned)."""

    __slots__ = ("reader", "writer")

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer


class MuxTransport:
    """The shared transport. Construct once per Client, ``close()`` when
    the Client closes. Thread-safe surface: :meth:`request` and
    :meth:`close`; everything else runs on the internal loop thread."""

    def __init__(self, base_url: str, pool_size: int = 4,
                 timeout: float = 10.0,
                 tls_context: Optional[ssl.SSLContext] = None) -> None:
        url = urllib.parse.urlsplit(base_url)
        self._host = url.hostname or "127.0.0.1"
        self._port = url.port or (443 if url.scheme == "https" else 80)
        self._base_path = url.path.rstrip("/")
        self._ssl = tls_context if url.scheme == "https" else None
        self.pool_size = max(1, int(pool_size))
        self.timeout = timeout
        # Socket accounting for the sublinear pins (tests read these
        # after the rollout; written only on the loop thread):
        # total sockets ever opened, and the high-water mark of
        # concurrently-open sockets — the number that must stay
        # <= pool_size however many worker threads drive the client.
        self.opened = 0  # thread-owned
        self.max_open = 0  # thread-owned
        self._open = 0  # thread-owned
        # idle-connection queue, created lazily ON the loop thread (an
        # asyncio.Queue must bind to the loop it serves); a ``None``
        # sentinel wakes one pool-full waiter after a discard freed
        # capacity
        self._idle: Optional["asyncio.Queue[Optional[_Conn]]"] = None  # thread-owned
        self._closed = False  # thread-owned
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name="mux-transport")
        self._thread.start()

    # ------------------------------------------------------------ lifecycle

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def close(self) -> None:
        """Close every pooled connection and stop the loop thread
        (idempotent; in-flight requests fail with MuxError)."""
        if not self._thread.is_alive():
            return
        try:
            fut = asyncio.run_coroutine_threadsafe(self._shutdown(),
                                                   self._loop)
            fut.result(5.0)
        except (RuntimeError, concurrent.futures.TimeoutError,
                concurrent.futures.CancelledError):
            pass
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
        except RuntimeError:
            pass
        self._thread.join(timeout=5.0)

    async def _shutdown(self) -> None:
        self._closed = True
        idle = self._idle
        if idle is None:
            return
        while True:
            try:
                item = idle.get_nowait()
            except asyncio.QueueEmpty:
                return
            if item is not None:
                self._close_writer(item)

    @staticmethod
    def _close_writer(conn: _Conn) -> None:
        try:
            conn.writer.close()
        except (OSError, RuntimeError):
            pass

    # ------------------------------------------------------------ public

    def request(self, method: str, path: str, headers: Dict[str, str],
                body: Optional[bytes], wall_s: float
                ) -> Tuple[int, Dict[str, str], bytes]:
        """One HTTP request through the shared pool, bounded by
        ``wall_s``: ``(status, lowercase-header dict, payload)``.
        Thread-safe and blocking; raises :class:`MuxDeadline` /
        :class:`MuxStale` / :class:`MuxError`."""
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self._do(method, path, headers, body, wall_s), self._loop)
        except RuntimeError as exc:  # loop closed under us
            raise MuxError(exc) from exc
        try:
            # generous outer bound: the coroutine's own wait_for is the
            # real wall — this only guards a wedged loop thread
            return fut.result(wall_s + self.timeout + 5.0)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise MuxDeadline() from None

    # ------------------------------------------------------------ loop side

    async def _do(self, method: str, path: str, headers: Dict[str, str],
                  body: Optional[bytes], wall_s: float
                  ) -> Tuple[int, Dict[str, str], bytes]:
        try:
            return await asyncio.wait_for(
                self._attempt(method, path, headers, body),
                timeout=max(0.001, wall_s))
        except asyncio.TimeoutError:
            raise MuxDeadline() from None

    async def _attempt(self, method: str, path: str,
                       headers: Dict[str, str], body: Optional[bytes]
                       ) -> Tuple[int, Dict[str, str], bytes]:
        reused, conn = await self._acquire()
        first_byte: List[bool] = []
        try:
            status, rheaders, payload, reusable = await self._roundtrip(
                conn, method, path, headers, body, first_byte)
        except asyncio.CancelledError:
            # the wall (wait_for) cancelled us mid-request: the
            # connection is mid-response and unusable
            self._discard(conn)
            raise
        except (OSError, EOFError, ValueError,
                asyncio.IncompleteReadError) as exc:
            self._discard(conn)
            if reused and not first_byte and isinstance(
                    exc, (ConnectionResetError, BrokenPipeError,
                          EOFError, asyncio.IncompleteReadError)):
                raise MuxStale(exc) from exc
            raise MuxError(exc) from exc
        if reusable:
            self._release(conn)
        else:
            self._discard(conn)
        return status, rheaders, payload

    async def _roundtrip(self, conn: _Conn, method: str, path: str,
                         headers: Dict[str, str], body: Optional[bytes],
                         first_byte: List[bool]
                         ) -> Tuple[int, Dict[str, str], bytes, bool]:
        data = body or b""
        req = [f"{method} {self._base_path + path} HTTP/1.1",
               f"Host: {self._host}:{self._port}"]
        for k, v in headers.items():
            req.append(f"{k}: {v}")
        if body is not None:
            req.append(f"Content-Length: {len(data)}")
        conn.writer.write(("\r\n".join(req) + "\r\n\r\n").encode() + data)
        await conn.writer.drain()
        status_line = await conn.reader.readline()
        if not status_line:
            raise asyncio.IncompleteReadError(b"", None)
        first_byte.append(True)
        parts = status_line.decode("latin-1").split(None, 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise ValueError(f"bad HTTP status line: {status_line!r}")
        status = int(parts[1])
        rheaders: Dict[str, str] = {}
        while True:
            line = await conn.reader.readline()
            if line in (b"\r\n", b"\n"):
                break
            if not line:
                raise asyncio.IncompleteReadError(b"", None)
            key, _, value = line.decode("latin-1").partition(":")
            rheaders[key.strip().lower()] = value.strip()
        close = "close" in rheaders.get("connection", "").lower()
        if status in (204, 304) or 100 <= status < 200:
            # bodyless BY DEFINITION (RFC 7230 §3.3.3): such a response
            # carries neither Content-Length nor chunked framing on a
            # kept-alive connection — falling through to read-to-EOF
            # below would park until the attempt wall severs a healthy
            # pooled socket and fails an actually-successful request
            payload = b""
        elif "chunked" in rheaders.get("transfer-encoding", "").lower():
            payload = await self._read_chunked(conn.reader)
        elif "content-length" in rheaders:
            payload = await conn.reader.readexactly(
                int(rheaders["content-length"]))
        else:
            # unframed body: read to EOF, connection not reusable
            payload = await conn.reader.read(-1)
            close = True
        return status, rheaders, payload, not close

    @staticmethod
    async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
        """Minimal chunked-transfer decode (the Python sibling of
        kubeclient::DecodeChunkedBody): hostile framing — garbage or
        negative sizes, missing terminators, EOF mid-chunk — raises
        (ValueError / IncompleteReadError) and classifies as transport
        failure, never as a short 200."""
        chunks: List[bytes] = []
        while True:
            size_line = await reader.readline()
            if not size_line:
                raise asyncio.IncompleteReadError(b"", None)
            try:
                size = int(size_line.strip().split(b";")[0], 16)
            except ValueError:
                raise ValueError(f"bad chunk size: {size_line!r}") from None
            if size < 0:
                raise ValueError(f"negative chunk size: {size_line!r}")
            if size == 0:
                while True:  # trailing headers until the blank line
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        return b"".join(chunks)
            chunks.append(await reader.readexactly(size))
            if await reader.readexactly(2) != b"\r\n":
                raise ValueError("missing chunk terminator")

    # ------------------------------------------------------------ pool

    async def _acquire(self) -> Tuple[bool, _Conn]:
        """``(reused, conn)`` — an idle pooled connection when one is
        healthy, a fresh socket while under ``pool_size``, else WAIT for
        one to free up (that queueing is the whole point: demand beyond
        the pool parks on the pool, it never opens sockets)."""
        idle = self._idle
        if idle is None:
            idle = self._idle = asyncio.Queue()
        while True:
            try:
                item: Optional[_Conn] = idle.get_nowait()
            except asyncio.QueueEmpty:
                if self._open < self.pool_size:
                    return False, await self._connect()
                item = await idle.get()
            if item is None:
                # sentinel: a discard freed capacity — re-check
                if self._open < self.pool_size:
                    return False, await self._connect()
                continue
            if item.reader.at_eof():
                self._discard(item)
                continue
            return True, item

    async def _connect(self) -> _Conn:
        if self._closed:
            raise MuxError(RuntimeError("mux transport closed"))
        # reserve the slot BEFORE the await: open_connection yields the
        # loop, and every coroutine parked on _acquire would otherwise
        # pass the `_open < pool_size` check during this one's connect
        # and blow the pool bound
        self._open += 1
        try:
            reader, writer = await asyncio.open_connection(
                self._host, self._port, ssl=self._ssl)
        except BaseException as exc:
            # OSError AND cancellation (the whole-attempt wall firing
            # mid-connect): either way the reserved slot must be
            # returned and a pool-full waiter woken, or the pool
            # shrinks permanently
            self._open -= 1
            idle = self._idle
            if idle is not None:
                idle.put_nowait(None)  # wake a pool-full waiter
            if isinstance(exc, OSError):
                raise MuxError(exc) from exc
            raise
        self.opened += 1
        self.max_open = max(self.max_open, self._open)
        return _Conn(reader, writer)

    def _release(self, conn: _Conn) -> None:
        idle = self._idle
        assert idle is not None
        idle.put_nowait(conn)

    def _discard(self, conn: _Conn) -> None:
        self._open -= 1
        self._close_writer(conn)
        idle = self._idle
        if idle is not None:
            idle.put_nowait(None)
