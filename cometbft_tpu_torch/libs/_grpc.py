"""gRPC over the port's HTTP/2 (``libs/_h2.py``): the wire protocol of
gRPC's ``PROTOCOL-HTTP2.md``, with no third-party package, and only what
the JAX package uses of ``grpc.aio``.

On the wire: a call is one HTTP/2 stream.  The request's headers are
``:method POST``, ``:scheme http``, ``:path /<service>/<method>``,
``:authority``, ``content-type: application/grpc`` and ``te: trailers``;
each message is a 5-byte prefix (a compressed flag, always 0 here, and a
32-bit big-endian length) and its bytes; the response is headers
(``:status 200``), its messages, then trailers with ``grpc-status`` and
a percent-encoded ``grpc-message``.  An error before any message is a
trailers-only response: one header block with both.

- :class:`Server`: a method table of unary-unary and unary-stream
  handlers (``UNIMPLEMENTED``, "Method not found!", for any other
  path), :meth:`Server.add_insecure_port` with port 0 for a free port,
  :meth:`Server.start` and :meth:`Server.stop` with a grace period.  A
  unary handler is ``async def (request: bytes) -> bytes``, a stream
  handler an async generator of ``bytes``; one that raises ends its call
  with ``UNKNOWN``.  A client that cancels a stream (RST_STREAM), or whose
  connection drops, cancels its handler, whose generator is closed.
- :class:`Channel` (:func:`insecure_channel`): connects at its first call,
  and again at the call after a lost connection;
  :meth:`Channel.unary_unary` and :meth:`Channel.unary_stream` give
  callables for a path.  A call that fails raises :class:`RpcError`
  with a :class:`StatusCode`: ``UNAVAILABLE`` for a refused connect or
  a dropped connection.  Leaving the ``async for`` over a stream call
  (or :meth:`UnaryStreamCall.cancel`) sends RST_STREAM(CANCEL).

grpcio's default limits hold on both sides, with its texts: a received
message over 4 MiB fails its call with ``RESOURCE_EXHAUSTED``, "SERVER:
Received message larger than max (N vs. 4194304)" at a server and
"CLIENT: ..." at a client; sent messages have no limit.
"""

from __future__ import annotations

import asyncio
import enum
import os
import socket
import struct

from . import _h2

__all__ = ["StatusCode", "RpcError", "Server", "Channel",
           "UnaryStreamCall", "insecure_channel",
           "MAX_RECEIVE_MESSAGE_LENGTH"]

MAX_RECEIVE_MESSAGE_LENGTH = 4 * 1024 * 1024     # grpcio's default
# each side's receive window, per stream and for the connection: a
# 4 MiB message arrives without waiting on a WINDOW_UPDATE
WINDOW = 1 << 22
_PREFIX = struct.Struct(">BI")


class StatusCode(enum.Enum):
    """gRPC status codes, as ``grpc.StatusCode`` names and values them."""

    OK = (0, "ok")
    CANCELLED = (1, "cancelled")
    UNKNOWN = (2, "unknown")
    INVALID_ARGUMENT = (3, "invalid argument")
    DEADLINE_EXCEEDED = (4, "deadline exceeded")
    NOT_FOUND = (5, "not found")
    ALREADY_EXISTS = (6, "already exists")
    PERMISSION_DENIED = (7, "permission denied")
    RESOURCE_EXHAUSTED = (8, "resource exhausted")
    FAILED_PRECONDITION = (9, "failed precondition")
    ABORTED = (10, "aborted")
    OUT_OF_RANGE = (11, "out of range")
    UNIMPLEMENTED = (12, "unimplemented")
    INTERNAL = (13, "internal")
    UNAVAILABLE = (14, "unavailable")
    DATA_LOSS = (15, "data loss")
    UNAUTHENTICATED = (16, "unauthenticated")


_BY_NUMBER = {c.value[0]: c for c in StatusCode}


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


def _percent_encode(text: str) -> bytes:
    out = bytearray()
    for b in text.encode("utf-8"):
        if 0x20 <= b <= 0x7E and b != 0x25:
            out.append(b)
        else:
            out += b"%%%02X" % b
    return bytes(out)


def _percent_decode(raw: bytes) -> str:
    out = bytearray()
    i = 0
    while i < len(raw):
        hexa = raw[i + 1:i + 3]
        if raw[i] == 0x25 and len(hexa) == 2 and all(
                c in b"0123456789abcdefABCDEF" for c in hexa):
            out.append(int(hexa, 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


def _frame(message: bytes) -> bytes:
    return _PREFIX.pack(0, len(message)) + bytes(message)


def _header_dict(headers) -> dict[str, bytes]:
    return {k.decode("latin-1"): v for k, v in headers}


def _status(headers: dict) -> RpcError | None:
    """``None`` for OK, else the error the trailers carry."""
    raw = headers.get("grpc-status")
    if raw is None:
        return RpcError(StatusCode.UNKNOWN, "missing grpc-status")
    try:
        code = _BY_NUMBER.get(int(raw), StatusCode.UNKNOWN)
    except ValueError:
        code = StatusCode.UNKNOWN
    if code is StatusCode.OK:
        return None
    return RpcError(code, _percent_decode(headers.get("grpc-message", b"")))


def _transport_error(e: Exception) -> RpcError:
    if isinstance(e, _h2.StreamReset):
        if e.code == _h2.REFUSED_STREAM:
            return RpcError(StatusCode.UNAVAILABLE, str(e))
        if e.code == _h2.CANCEL:
            return RpcError(StatusCode.CANCELLED, str(e))
        return RpcError(StatusCode.INTERNAL,
                        f"Received RST_STREAM with error code {e.code}")
    return RpcError(StatusCode.UNAVAILABLE, str(e))


class _Messages:
    """Length-prefixed messages from a stream's data, each refused once
    its prefix declares more than ``MAX_RECEIVE_MESSAGE_LENGTH`` bytes
    (``side`` names the receiver in the error's text, as grpcio's)."""

    def __init__(self, stream: _h2.Stream, side: str):
        self._stream = stream
        self._side = side
        self._buf = bytearray()

    async def next(self) -> bytes | None:
        """The next message; ``None`` at the end of the stream."""
        limit = MAX_RECEIVE_MESSAGE_LENGTH
        while True:
            if len(self._buf) >= _PREFIX.size:
                flag, n = _PREFIX.unpack_from(self._buf)
                if flag:
                    raise RpcError(StatusCode.INTERNAL,
                                   "compressed message without grpc-encoding")
                if n > limit:
                    raise RpcError(
                        StatusCode.RESOURCE_EXHAUSTED,
                        f"{self._side}: Received message larger than max "
                        f"({n} vs. {limit})")
                need = _PREFIX.size + n
                if len(self._buf) >= need:
                    msg = bytes(self._buf[_PREFIX.size:need])
                    del self._buf[:need]
                    return msg
            chunk = await self._stream.read()
            if not chunk:
                if self._buf:
                    raise RpcError(StatusCode.INTERNAL,
                                   "the stream ended inside a message")
                return None
            self._buf += chunk


# ---------------------------------------------------------------- server

_RESPONSE_HEADERS = ((b":status", b"200"),
                     (b"content-type", b"application/grpc"))


def _trailers(code: StatusCode, details: str = "",
              only: bool = False) -> list:
    out = list(_RESPONSE_HEADERS) if only else []
    out.append((b"grpc-status", b"%d" % code.value[0]))
    if details:
        out.append((b"grpc-message", _percent_encode(details)))
    return out


class Server:
    """A gRPC server of a method table: ``unary_unary`` and
    ``unary_stream`` map a path (``/service/Method``) to its handler."""

    def __init__(self, unary_unary: dict | None = None,
                 unary_stream: dict | None = None):
        self._unary = dict(unary_unary or {})
        self._stream = dict(unary_stream or {})
        self._socks: list[socket.socket] = []
        self._listeners: list[asyncio.AbstractServer] = []
        self._conns: set[_h2.Connection] = set()
        self._tasks: set[asyncio.Task] = set()

    def add_insecure_port(self, address: str) -> int:
        """Bind ``host:port`` (port 0: a free one) and return the port;
        connections are accepted from :meth:`start`."""
        host, _, port = address.rpartition(":")
        host = host.strip("[]") or "0.0.0.0"
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        sock = socket.create_server((host, int(port)), family=family)
        self._socks.append(sock)
        return sock.getsockname()[1]

    async def start(self) -> None:
        for sock in self._socks:
            self._listeners.append(await asyncio.start_server(
                self._on_connection, sock=sock))

    async def stop(self, grace: float | None = None) -> None:
        """Accept nothing new, send GOAWAY, give the calls in flight
        ``grace`` seconds, then cancel them and close every connection."""
        for lst in self._listeners:
            lst.close()
        self._listeners.clear()
        self._socks.clear()
        for conn in list(self._conns):
            conn.goaway()
        tasks = set(self._tasks)
        if tasks and grace:
            await asyncio.wait(tasks, timeout=grace)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.wait(tasks)
        for conn in list(self._conns):
            await conn.close()

    async def _on_connection(self, reader, writer) -> None:
        conn = _h2.Connection(reader, writer, client=False,
                              on_stream=self._on_stream, window=WINDOW)
        self._conns.add(conn)
        try:
            await conn.start()
            await conn.closed.wait()
        except _h2.ConnectionClosed:
            pass
        finally:
            self._conns.discard(conn)
            await conn.close()

    def _on_stream(self, stream: _h2.Stream) -> None:
        task = asyncio.create_task(self._serve(stream))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        # the client's RST_STREAM, or its connection lost: the handler
        # (and a stream handler's generator) stops
        stream.on_reset = task.cancel

    async def _serve(self, stream: _h2.Stream) -> None:
        try:
            await self._call(stream)
            if not stream.ended:
                # answered before the request ended: it need send no more
                stream.reset(_h2.NO_ERROR)
        except (_h2.StreamReset, _h2.ConnectionClosed):
            pass                            # the client is gone

    async def _call(self, stream: _h2.Stream) -> None:
        headers = _header_dict(stream.headers.result())
        path = headers.get(":path", b"").decode("latin-1")
        unary = self._unary.get(path)
        gen_fn = self._stream.get(path)
        if unary is None and gen_fn is None:
            await stream.send_headers(_trailers(
                StatusCode.UNIMPLEMENTED, "Method not found!", only=True),
                end_stream=True)
            return
        try:
            request = await _Messages(stream, "SERVER").next()
            if request is None:
                raise RpcError(StatusCode.INTERNAL, "no request message")
        except RpcError as e:
            await stream.send_headers(_trailers(e.code(), e.details(),
                                                only=True), end_stream=True)
            return
        if unary is not None:
            try:
                response = await unary(request)
            except Exception as e:
                await stream.send_headers(_trailers(
                    StatusCode.UNKNOWN, f"Unexpected {type(e)}: {e}",
                    only=True), end_stream=True)
                return
            await stream.send_headers(_RESPONSE_HEADERS)
            await stream.send_data(_frame(response))
            await stream.send_headers(_trailers(StatusCode.OK),
                                      end_stream=True)
            return
        gen = gen_fn(request)
        try:
            await stream.send_headers(_RESPONSE_HEADERS)
            try:
                async for item in gen:
                    await stream.send_data(_frame(item))
            except (_h2.StreamReset, _h2.ConnectionClosed):
                raise
            except Exception as e:
                await stream.send_headers(_trailers(
                    StatusCode.UNKNOWN, f"Unexpected {type(e)}: {e}"),
                    end_stream=True)
                return
            await stream.send_headers(_trailers(StatusCode.OK),
                                      end_stream=True)
        finally:
            await gen.aclose()


# ---------------------------------------------------------------- client

class _Call:
    """One call's stream: the request sent beside the response read."""

    def __init__(self, channel: "Channel", path: str, request: bytes):
        self._channel = channel
        self._path = path
        self._request = request
        self._stream: _h2.Stream | None = None
        self._sender: asyncio.Task | None = None
        self._msgs: _Messages | None = None
        self._done = False

    async def start(self) -> None:
        conn = await self._channel._connection()
        headers = [(b":method", b"POST"), (b":scheme", b"http"),
                   (b":path", self._path.encode()),
                   (b":authority", self._channel.authority.encode()),
                   (b"content-type", b"application/grpc"),
                   (b"te", b"trailers")]
        try:
            self._stream = await conn.open_stream(headers)
        except _h2.ConnectionClosed as e:
            raise self._channel._error(e) from e
        self._sender = asyncio.create_task(self._send())
        self._msgs = _Messages(self._stream, "CLIENT")
        try:
            got = _header_dict(await self._stream.headers)
        except (_h2.StreamReset, _h2.ConnectionClosed) as e:
            raise self._channel._error(e) from e
        if "grpc-status" in got:                        # trailers-only
            self._done = True
            err = _status(got)
            if err is not None:
                raise err
            return
        if got.get(":status") != b"200":
            self.cancel()
            raise RpcError(StatusCode.UNKNOWN,
                           f"HTTP status {got.get(':status')!r}")

    async def _send(self) -> None:
        try:
            await self._stream.send_data(_frame(self._request),
                                         end_stream=True)
        except (_h2.StreamReset, _h2.ConnectionClosed):
            pass                       # the response says what happened

    async def message(self) -> bytes | None:
        """The next response message; ``None`` after an OK status."""
        if self._done:
            return None
        try:
            msg = await self._msgs.next()
        except RpcError:
            self.cancel()
            raise
        except (_h2.StreamReset, _h2.ConnectionClosed) as e:
            raise self._channel._error(e) from e
        if msg is not None:
            return msg
        self._done = True
        err = _status(_header_dict(self._stream.trailers or []))
        if err is not None:
            raise err
        return None

    def cancel(self) -> None:
        if self._stream is not None:
            self._stream.reset(_h2.CANCEL)
        if self._sender is not None:
            self._sender.cancel()


class _UnaryUnary:
    def __init__(self, channel: "Channel", path: str):
        self._channel = channel
        self._path = path

    async def __call__(self, request: bytes) -> bytes:
        call = _Call(self._channel, self._path, request)
        try:
            await call.start()
            response = await call.message()
            if response is None:
                raise RpcError(StatusCode.INTERNAL, "no response message")
            if await call.message() is not None:
                raise RpcError(StatusCode.INTERNAL,
                               "more than one response message")
            return response
        finally:
            call.cancel()


class UnaryStreamCall:
    """A server-streaming call: iterate it for the response messages."""

    def __init__(self, channel: "Channel", path: str, request: bytes):
        self._call = _Call(channel, path, request)

    def __aiter__(self):
        return self._messages()

    async def _messages(self):
        try:
            await self._call.start()
            while True:
                msg = await self._call.message()
                if msg is None:
                    return
                yield msg
        finally:
            self._call.cancel()

    def cancel(self) -> None:
        self._call.cancel()


class _UnaryStream:
    def __init__(self, channel: "Channel", path: str):
        self._channel = channel
        self._path = path

    def __call__(self, request: bytes) -> UnaryStreamCall:
        return UnaryStreamCall(self._channel, self._path, request)


class Channel:
    """A channel to ``host:port`` without TLS, connected at its first
    call; a lost connection is replaced at the next call."""

    def __init__(self, target: str):
        host, _, port = target.rpartition(":")
        self.authority = target
        self.host = host.strip("[]") or "127.0.0.1"
        self.port = int(port)
        self._conn: _h2.Connection | None = None
        self._lock = asyncio.Lock()
        self._closed = False

    def unary_unary(self, path: str) -> _UnaryUnary:
        return _UnaryUnary(self, path)

    def unary_stream(self, path: str) -> _UnaryStream:
        return _UnaryStream(self, path)

    async def _connection(self) -> _h2.Connection:
        async with self._lock:
            if self._closed:
                raise RpcError(StatusCode.CANCELLED, "Channel closed!")
            conn = self._conn
            if conn is None or conn.error is not None \
                    or conn.goaway_received is not None:
                try:
                    reader, writer = await asyncio.open_connection(
                        self.host, self.port)
                except OSError as e:
                    why = os.strerror(e.errno) if e.errno else str(e)
                    raise RpcError(
                        StatusCode.UNAVAILABLE,
                        "failed to connect to all addresses; last error: "
                        f"UNKNOWN: ipv4:{self.host}:{self.port}: Failed to "
                        f"connect to remote host: connect: {why} "
                        f"({e.errno})") from e
                conn = _h2.Connection(reader, writer, client=True,
                                      window=WINDOW)
                try:
                    await conn.start()
                except _h2.ConnectionClosed as e:
                    raise RpcError(StatusCode.UNAVAILABLE, str(e)) from e
                self._conn = conn
            return conn

    def _error(self, e: Exception) -> RpcError:
        if self._closed:
            return RpcError(StatusCode.CANCELLED, "Channel closed!")
        return _transport_error(e)

    async def close(self) -> None:
        """Close the connection; calls in flight end ``CANCELLED``."""
        self._closed = True
        conn, self._conn = self._conn, None
        if conn is not None:
            await conn.close()


def insecure_channel(target: str) -> Channel:
    return Channel(target)
