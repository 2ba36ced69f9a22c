"""HTTP/2 over cleartext TCP with prior knowledge (RFC 9113, "h2c"), on
``asyncio`` streams, with its header compression HPACK (RFC 7541): the
part of an HTTP/2 package that the port's gRPC (``libs/_grpc.py``)
needs, with no third-party package.

Frames: the connection preface; SETTINGS and their ACK (unknown ids are
ignored: grpcio sends some of its own); HEADERS with CONTINUATION and the
PADDED and PRIORITY flags; DATA, split at the peer's
``SETTINGS_MAX_FRAME_SIZE``; PING, answered with its ACK; RST_STREAM;
GOAWAY; WINDOW_UPDATE; PRIORITY (read and ignored).  Flow control per
stream and per connection: data is sent only within the peer's windows,
and received data is given back with WINDOW_UPDATE as the reader
consumes it (once half a window is consumed).  A client opens no more
streams than the peer's ``SETTINGS_MAX_CONCURRENT_STREAMS``.  Server
push is refused (``SETTINGS_ENABLE_PUSH = 0``).

HPACK: the decoder has the static table, a dynamic table with size
updates and eviction, and Huffman decoding (the code of Appendix B is
:data:`HUFFMAN_CODES`; :func:`huffman_encode` is its inverse); the
encoder (:func:`encode_headers`) writes each field as an index into the
static table where the whole field is there, else as a literal without
indexing, not Huffman-coded, so it keeps no table.  Header names and
values are ``bytes``.

A :class:`Connection` runs one reader task; frames are written whole
with one ``write`` each (a header block and its CONTINUATION frames in
one), so tasks that send on several streams never interleave inside a
frame.  Errors: a connection error (:class:`H2Error`) sends GOAWAY and
closes; a stream that the peer or this side resets raises
:class:`StreamReset` to its reader and writer; a lost or closed
connection raises :class:`ConnectionClosed` to every stream.
"""

from __future__ import annotations

import asyncio
import collections
import socket
import struct

__all__ = ["PREFACE", "H2Error", "StreamReset", "ConnectionClosed",
           "HPACKError", "encode_headers", "Decoder", "HeaderTable",
           "STATIC_TABLE", "HUFFMAN_CODES", "huffman_encode",
           "huffman_decode", "encode_frame", "decode_frame_header",
           "Stream", "Connection"]

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 9113 section 6)
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, \
    GOAWAY, WINDOW_UPDATE, CONTINUATION = range(10)
# flags
END_STREAM = 0x1
ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20
# settings (section 6.5.2)
SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_HEADER_LIST_SIZE = 0x6
# error codes (section 7)
NO_ERROR = 0x0
PROTOCOL_ERROR = 0x1
INTERNAL_ERROR = 0x2
FLOW_CONTROL_ERROR = 0x3
STREAM_CLOSED = 0x5
FRAME_SIZE_ERROR = 0x6
REFUSED_STREAM = 0x7
CANCEL = 0x8
COMPRESSION_ERROR = 0x9

DEFAULT_WINDOW = 65_535
MAX_WINDOW = 2**31 - 1
DEFAULT_MAX_FRAME = 16_384
MAX_FRAME_LIMIT = 2**24 - 1
DEFAULT_TABLE_SIZE = 4_096
MAX_HEADER_BLOCK = 1 << 20        # a header block longer than this is refused


class H2Error(Exception):
    """A connection error: the connection sends GOAWAY with ``code``."""

    def __init__(self, code: int, msg: str):
        super().__init__(f"{msg} (error code {code})")
        self.code = code


class HPACKError(Exception):
    """A header block that does not decode (a COMPRESSION_ERROR)."""


class StreamReset(Exception):
    """The stream was reset with ``code``, by the peer (``remote``) or by
    this side."""

    def __init__(self, code: int, remote: bool):
        side = "peer" if remote else "local side"
        super().__init__(f"stream reset by the {side} with error code "
                         f"{code}")
        self.code = code
        self.remote = remote


class ConnectionClosed(Exception):
    """The connection is closed or lost, or the peer sent GOAWAY before
    this stream."""


# ---------------------------------------------------------------- frames

_FH = struct.Struct(">BHBBI")       # length as 8 + 16 bits, type, flags, id


def encode_frame(ftype: int, flags: int, stream_id: int,
                 payload: bytes = b"") -> bytes:
    n = len(payload)
    if n > MAX_FRAME_LIMIT:
        raise ValueError(f"frame payload of {n} bytes")
    return _FH.pack(n >> 16, n & 0xFFFF, ftype, flags,
                    stream_id & 0x7FFFFFFF) + bytes(payload)


def decode_frame_header(buf: bytes) -> tuple[int, int, int, int]:
    """(length, type, flags, stream id) of a 9-byte frame header; the
    reserved bit of the stream id is ignored."""
    hi, lo, ftype, flags, sid = _FH.unpack(buf)
    return (hi << 16) | lo, ftype, flags, sid & 0x7FFFFFFF


# ----------------------------------------------------------------- HPACK

STATIC_TABLE = tuple((n.encode(), v.encode()) for n, v in (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", "")))
_STATIC_FIELD = {f: i + 1 for i, f in reversed(list(enumerate(
    STATIC_TABLE)))}
_STATIC_NAME = {n: i + 1 for i, (n, _) in reversed(list(enumerate(
    STATIC_TABLE)))}

# RFC 7541 Appendix B: (code, length in bits) of symbols 0-255 and EOS
# (256).  The code is canonical: within a length the codes count up in
# symbol order, and each length's first code follows the last code of
# the length before it.
HUFFMAN_CODES = (
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),                # ' '-'#'
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),                 # '$'-"'"
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),                # '('-'+'
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),                      # ','-'/'
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),                         # '0'-'3'
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),                      # '4'-'7'
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),                      # '8'-';'
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),               # '<'-'?'
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),                   # '@'-'C'
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),                      # 'D'-'G'
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),                      # 'H'-'K'
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),                      # 'L'-'O'
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),                      # 'P'-'S'
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),                      # 'T'-'W'
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),                   # 'X'-'['
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),            # '\'-'_'
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),                     # '`'-'c'
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),                       # 'd'-'g'
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),                       # 'h'-'k'
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),                       # 'l'-'o'
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),                       # 'p'-'s'
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),                       # 't'-'w'
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),                   # 'x'-'{'
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),        # '|'-127
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),     # 128-131
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),  # 144-
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),   # 160-
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),  # 176-
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),  # 192-
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),  # 208-
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),    # 224-
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),  # 240-
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),                                                # EOS
)
EOS = 256
_HUFFMAN_DECODE = {(bits, code): sym
                   for sym, (code, bits) in enumerate(HUFFMAN_CODES)}


def huffman_encode(data: bytes) -> bytes:
    acc = nbits = 0
    for b in data:
        code, bits = HUFFMAN_CODES[b]
        acc = (acc << bits) | code
        nbits += bits
    pad = -nbits % 8                  # the most significant bits of EOS
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    """Decode a Huffman-coded string; padding longer than 7 bits, padding
    that is not the most significant bits of EOS, and an EOS inside the
    string raise :class:`HPACKError`."""
    out = bytearray()
    code = bits = 0
    table = _HUFFMAN_DECODE
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            bits += 1
            if bits >= 5:
                sym = table.get((bits, code))
                if sym is not None:
                    if sym == EOS:
                        raise HPACKError("EOS inside a Huffman string")
                    out.append(sym)
                    code = bits = 0
            if bits > 30:
                raise HPACKError("invalid Huffman code")
    if bits > 7 or code != (1 << bits) - 1:
        raise HPACKError("invalid Huffman padding")
    return bytes(out)


def _encode_int(value: int, prefix: int, first: int) -> bytes:
    """``value`` with a ``prefix``-bit prefix, the first byte's other
    bits from ``first`` (RFC 7541 section 5.1)."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes((first | value,))
    out = bytearray((first | limit,))
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _decode_int(buf: bytes, pos: int, prefix: int) -> tuple[int, int]:
    if pos >= len(buf):
        raise HPACKError("truncated integer")
    limit = (1 << prefix) - 1
    value = buf[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(buf):
            raise HPACKError("truncated integer")
        b = buf[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 28:
            raise HPACKError("integer overflow")


def _encode_str(s: bytes) -> bytes:
    """A string literal, not Huffman-coded."""
    return _encode_int(len(s), 7, 0) + s


def _decode_str(buf: bytes, pos: int) -> tuple[bytes, int]:
    if pos >= len(buf):
        raise HPACKError("truncated string")
    huff = buf[pos] & 0x80
    n, pos = _decode_int(buf, pos, 7)
    end = pos + n
    if end > len(buf):
        raise HPACKError("truncated string")
    raw = buf[pos:end]
    return (huffman_decode(raw) if huff else bytes(raw)), end


class HeaderTable:
    """The dynamic table: newest entry first, each entry's size its
    name's and value's lengths plus 32 (section 4.1); entries are evicted
    from the oldest end to keep within ``max_size``."""

    def __init__(self, max_size: int = DEFAULT_TABLE_SIZE):
        self.max_size = max_size
        self.size = 0
        self.entries: collections.deque = collections.deque()

    @staticmethod
    def entry_size(name: bytes, value: bytes) -> int:
        return len(name) + len(value) + 32

    def _evict(self, room: int) -> None:
        while self.entries and self.size > room:
            n, v = self.entries.pop()
            self.size -= self.entry_size(n, v)

    def add(self, name: bytes, value: bytes) -> None:
        """An entry larger than the table empties it (section 4.4)."""
        size = self.entry_size(name, value)
        self._evict(self.max_size - size)
        if size <= self.max_size:
            self.entries.appendleft((name, value))
            self.size += size

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict(max_size)

    def get(self, index: int) -> tuple[bytes, bytes]:
        """Entry ``index`` of the combined address space: 1-61 static,
        62 on dynamic."""
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if 0 <= i < len(self.entries):
            return self.entries[i]
        raise HPACKError(f"header index {index} out of range")


class Decoder:
    """HPACK decoder of one connection's header blocks, in order.  This
    side advertises the default ``SETTINGS_HEADER_TABLE_SIZE``: a size
    update above it is a decoding error."""

    def __init__(self):
        self.table = HeaderTable()

    def decode(self, block: bytes) -> list[tuple[bytes, bytes]]:
        buf = bytes(block)
        pos = 0
        out: list = []
        table = self.table
        while pos < len(buf):
            b = buf[pos]
            if b & 0x80:                                  # indexed field
                i, pos = _decode_int(buf, pos, 7)
                if i == 0:
                    raise HPACKError("header index 0")
                out.append(table.get(i))
            elif b & 0x40:                   # literal, incremental index
                i, pos = _decode_int(buf, pos, 6)
                name, value, pos = self._literal(buf, pos, i)
                table.add(name, value)
                out.append((name, value))
            elif b & 0x20:                         # dynamic table size
                if out:
                    raise HPACKError("table size update after a field")
                n, pos = _decode_int(buf, pos, 5)
                if n > DEFAULT_TABLE_SIZE:
                    raise HPACKError(f"table size update to {n}, above "
                                     f"{DEFAULT_TABLE_SIZE}")
                table.resize(n)
            else:                 # literal without indexing, never indexed
                i, pos = _decode_int(buf, pos, 4)
                name, value, pos = self._literal(buf, pos, i)
                out.append((name, value))
        return out

    def _literal(self, buf: bytes, pos: int, index: int):
        if index:
            name = self.table.get(index)[0]
        else:
            name, pos = _decode_str(buf, pos)
        value, pos = _decode_str(buf, pos)
        return name, value, pos


def encode_headers(headers) -> bytes:
    """A header block: a field wholly in the static table as its index,
    any other as a literal without indexing (its name indexed where the
    static table has it)."""
    out = bytearray()
    for name, value in headers:
        i = _STATIC_FIELD.get((name, value))
        if i:
            out += _encode_int(i, 7, 0x80)
            continue
        i = _STATIC_NAME.get(name, 0)
        out += _encode_int(i, 4, 0x00)
        if not i:
            out += _encode_str(name)
        out += _encode_str(value)
    return bytes(out)


# ------------------------------------------------------------ connection

class Stream:
    """One HTTP/2 stream.  ``headers`` resolves to the first header
    block received; ``trailers`` holds a second block (with END_STREAM);
    :meth:`read` returns received data chunk by chunk and ``b""`` at
    the end.  ``on_reset`` (if set) is called once when the peer resets
    the stream or the connection ends before the stream did."""

    def __init__(self, conn: "Connection", stream_id: int):
        self.conn = conn
        self.id = stream_id
        self.send_window = conn.peer_initial_window
        self.recv_window = conn.local_window
        self.headers: asyncio.Future = \
            asyncio.get_running_loop().create_future()
        self.trailers: list | None = None
        self.ended = False            # END_STREAM received
        self.sent_end = False         # END_STREAM sent
        self.reset_code: int | None = None
        self.reset_remote = False
        self.on_reset = None
        self._chunks: collections.deque = collections.deque()
        self._readable = asyncio.Event()
        self._unacked = 0             # consumed, not yet given back

    @property
    def closed(self) -> bool:
        return self.reset_code is not None or (self.ended and self.sent_end)

    async def read(self) -> bytes:
        while True:
            if self._chunks:
                chunk = self._chunks.popleft()
                self.conn._consumed(self, len(chunk))
                return chunk
            if self.ended:
                return b""
            self._check()
            self._readable.clear()
            await self._readable.wait()

    def _check(self) -> None:
        if self.reset_code is not None:
            raise StreamReset(self.reset_code, self.reset_remote)
        if self.conn.error is not None:
            raise ConnectionClosed(self.conn.error)

    async def send_headers(self, headers, end_stream: bool = False) -> None:
        self._check()
        self.conn._write_headers(self, headers, end_stream)
        await self.conn._drain()

    async def send_data(self, data: bytes, end_stream: bool = False) -> None:
        await self.conn._send_data(self, data, end_stream)

    def reset(self, code: int = CANCEL) -> None:
        """Send RST_STREAM(``code``) unless the stream is closed."""
        if not self.closed:
            self.conn._reset(self, code, remote=False)

    def _wake(self) -> None:
        self._readable.set()


class Connection:
    """One HTTP/2 connection over ``reader``/``writer``.  A client
    (``client=True``) sends the preface and opens streams
    (:meth:`open_stream`); a server reads the preface and hands each new
    stream to ``on_stream(stream)`` once its first header block is in.
    ``window`` is this side's receive window, per stream
    (``SETTINGS_INITIAL_WINDOW_SIZE``) and for the connection (raised
    from 65,535 with a WINDOW_UPDATE at start)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *, client: bool,
                 on_stream=None, window: int = DEFAULT_WINDOW):
        self.reader = reader
        self.writer = writer
        self.client = client
        self.on_stream = on_stream
        self.local_window = window
        self.local_max_frame = DEFAULT_MAX_FRAME
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.peer_max_streams: int | None = None
        self.send_window = DEFAULT_WINDOW           # the peer's, for us
        self.recv_window = DEFAULT_WINDOW           # ours, for the peer
        self.streams: dict[int, Stream] = {}
        self.decoder = Decoder()
        self.error: str | None = None               # set once it ends
        self.goaway_received: tuple[int, int] | None = None
        self.goaway_sent = False
        self._next_id = 1 if client else 2
        self._last_peer_id = 0
        self._continuation: tuple | None = None
        self._conn_unacked = 0
        self._window_waiters: list[asyncio.Future] = []
        self._slot_waiters: list[asyncio.Future] = []
        self._settings_seen = False
        self._task: asyncio.Task | None = None
        self.closed = asyncio.Event()
        self._handlers = {
            DATA: self._on_data, HEADERS: self._on_headers,
            PRIORITY: self._on_priority, RST_STREAM: self._on_rst_stream,
            SETTINGS: self._on_settings, PUSH_PROMISE: self._on_push,
            PING: self._on_ping, GOAWAY: self._on_goaway,
            WINDOW_UPDATE: self._on_window_update,
            CONTINUATION: self._on_continuation}

    # -------------------------------------------------------- lifecycle

    async def start(self) -> None:
        sock = self.writer.get_extra_info("socket")
        if sock is not None and sock.family in (socket.AF_INET,
                                                socket.AF_INET6):
            # asyncio sets this only where the socket's proto field is
            # TCP; an accepted socket of ``socket.create_server`` has 0,
            # and a frame held back by Nagle waits for a delayed ACK
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        settings = [(SETTINGS_INITIAL_WINDOW_SIZE, self.local_window)]
        if self.client:
            settings.append((SETTINGS_ENABLE_PUSH, 0))
        out = PREFACE if self.client else b""
        out += encode_frame(SETTINGS, 0, 0, b"".join(
            struct.pack(">HI", k, v) for k, v in settings))
        if self.local_window > DEFAULT_WINDOW:
            out += encode_frame(WINDOW_UPDATE, 0, 0, struct.pack(
                ">I", self.local_window - DEFAULT_WINDOW))
            self.recv_window = self.local_window
        self.writer.write(out)
        self._task = asyncio.create_task(self._run())
        await self._drain()

    async def close(self, code: int = NO_ERROR) -> None:
        """GOAWAY (unless the connection has ended), then close the
        socket and wait for the reader task."""
        if self.error is None:
            self._goaway(code)
            self._end("closed by the local side")
        if self._task is not None:
            if self._task is not asyncio.current_task():
                self._task.cancel()
                try:
                    await self._task
                except asyncio.CancelledError:
                    pass
        try:
            await self.writer.wait_closed()
        except (OSError, RuntimeError):
            pass

    def goaway(self, code: int = NO_ERROR) -> None:
        """Send GOAWAY: the peer opens no more streams; those open go
        on."""
        if self.error is None and not self.goaway_sent:
            self._goaway(code)

    def _goaway(self, code: int) -> None:
        self.goaway_sent = True
        try:
            self.writer.write(encode_frame(GOAWAY, 0, 0, struct.pack(
                ">II", self._last_peer_id, code)))
        except (OSError, RuntimeError):
            pass

    def _end(self, why: str) -> None:
        """The connection is over: every stream not closed and every
        window and stream-slot waiter fails."""
        if self.error is not None:
            return
        self.error = why
        self.writer.close()
        for s in list(self.streams.values()):
            self._drop(s)
            s._wake()
            if not s.headers.done():
                s.headers.set_exception(ConnectionClosed(why))
                s.headers.exception()         # read: no "never retrieved"
            if s.on_reset is not None and not (s.ended and s.sent_end):
                s.on_reset()
        self._wake_windows()
        self._wake_slots()
        self.closed.set()

    async def _run(self) -> None:
        try:
            if not self.client:
                if await self.reader.readexactly(len(PREFACE)) != PREFACE:
                    raise H2Error(PROTOCOL_ERROR, "bad connection preface")
            while True:
                head = await self.reader.readexactly(9)
                length, ftype, flags, sid = decode_frame_header(head)
                if length > self.local_max_frame:
                    raise H2Error(FRAME_SIZE_ERROR,
                                  f"frame of {length} bytes")
                payload = await self.reader.readexactly(length) \
                    if length else b""
                if not self._settings_seen:
                    if ftype != SETTINGS or flags & ACK:
                        raise H2Error(PROTOCOL_ERROR,
                                      "first frame is not SETTINGS")
                    self._settings_seen = True
                if self._continuation is not None and (
                        ftype != CONTINUATION
                        or sid != self._continuation[0]):
                    raise H2Error(PROTOCOL_ERROR,
                                  "header block interrupted")
                handler = self._handlers.get(ftype)
                if handler is not None:           # unknown types: ignored
                    handler(flags, sid, payload)
        except H2Error as e:
            self._goaway(e.code)
            self._end(str(e))
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                ConnectionClosed) as e:
            self._end(f"connection lost: {e!r}")
        except asyncio.CancelledError:
            self._end("closed by the local side")
            raise
        else:
            self._end("connection ended")

    # ------------------------------------------------------------ send

    def _write(self, data: bytes) -> None:
        if self.error is not None:
            raise ConnectionClosed(self.error)
        self.writer.write(data)

    async def _drain(self) -> None:
        try:
            await self.writer.drain()
        except (ConnectionError, OSError) as e:
            self._end(f"connection lost: {e!r}")
            raise ConnectionClosed(self.error) from e

    def _write_headers(self, stream: Stream, headers,
                       end_stream: bool) -> None:
        block = encode_headers(headers)
        step = self.peer_max_frame
        parts = [block[i:i + step] for i in range(0, len(block), step)] \
            or [b""]
        frames = []
        for i, part in enumerate(parts):
            flags = END_HEADERS if i == len(parts) - 1 else 0
            if i == 0:
                if end_stream:
                    flags |= END_STREAM
                frames.append(encode_frame(HEADERS, flags, stream.id, part))
            else:
                frames.append(encode_frame(CONTINUATION, flags, stream.id,
                                           part))
        self._write(b"".join(frames))
        if end_stream:
            stream.sent_end = True
            self._maybe_forget(stream)

    async def open_stream(self, headers, end_stream: bool = False) -> Stream:
        """A new client stream with ``headers`` sent; waits while the
        peer's concurrent-stream limit is reached."""
        while True:
            if self.error is not None:
                raise ConnectionClosed(self.error)
            if self.goaway_received is not None:
                raise ConnectionClosed("the peer sent GOAWAY")
            if self._next_id > MAX_WINDOW:
                raise ConnectionClosed("stream ids exhausted")
            limit = self.peer_max_streams
            if limit is None or len(self.streams) < limit:
                break
            fut = asyncio.get_running_loop().create_future()
            self._slot_waiters.append(fut)
            await fut
        # the id and its HEADERS with no await between: ids go out in
        # increasing order
        stream = Stream(self, self._next_id)
        self._next_id += 2
        self.streams[stream.id] = stream
        self._write_headers(stream, headers, end_stream)
        await self._drain()
        return stream

    async def _send_data(self, stream: Stream, data: bytes,
                         end_stream: bool) -> None:
        view = memoryview(bytes(data))
        off = 0
        while True:
            stream._check()
            if stream.sent_end:
                raise StreamReset(STREAM_CLOSED, False)
            left = len(view) - off
            room = min(self.send_window, stream.send_window)
            if left and room <= 0:
                fut = asyncio.get_running_loop().create_future()
                self._window_waiters.append(fut)
                await fut
                continue
            n = min(left, room, self.peer_max_frame)
            last = off + n == len(view)
            flags = END_STREAM if last and end_stream else 0
            self._write(encode_frame(DATA, flags, stream.id, view[off:off + n]))
            self.send_window -= n
            stream.send_window -= n
            off += n
            if last:
                if end_stream:
                    stream.sent_end = True
                    self._maybe_forget(stream)
                await self._drain()
                return
            await self._drain()

    def _reset(self, stream: Stream, code: int, remote: bool) -> None:
        if not remote:
            try:
                self._write(encode_frame(RST_STREAM, 0, stream.id,
                                         struct.pack(">I", code)))
            except ConnectionClosed:
                pass
        stream.reset_code = code
        stream.reset_remote = remote
        if not stream.ended:
            # nothing more is read: what is buffered goes back to the
            # connection's window
            n = sum(len(c) for c in stream._chunks)
            stream._chunks.clear()
            self._consumed(None, n)
        self._drop(stream)
        stream._wake()
        if not stream.headers.done():
            stream.headers.set_exception(StreamReset(code, remote))
            stream.headers.exception()
        self._wake_windows()
        if remote and stream.on_reset is not None:
            stream.on_reset()

    def _drop(self, stream: Stream) -> None:
        if self.streams.pop(stream.id, None) is not None:
            self._wake_slots()
            if self.goaway_received is not None and not self.streams:
                self._end("the peer sent GOAWAY")

    def _maybe_forget(self, stream: Stream) -> None:
        if stream.ended and stream.sent_end:
            self._drop(stream)

    def _consumed(self, stream: Stream | None, n: int) -> None:
        """``n`` received bytes are consumed: give them back with
        WINDOW_UPDATE once half a window has gathered."""
        if self.error is not None or n <= 0:
            return
        out = b""
        self._conn_unacked += n
        if self._conn_unacked >= self.local_window // 2:
            out += encode_frame(WINDOW_UPDATE, 0, 0,
                                struct.pack(">I", self._conn_unacked))
            self.recv_window += self._conn_unacked
            self._conn_unacked = 0
        if stream is not None and not stream.ended \
                and stream.reset_code is None:
            stream._unacked += n
            if stream._unacked >= self.local_window // 2:
                out += encode_frame(WINDOW_UPDATE, 0, stream.id,
                                    struct.pack(">I", stream._unacked))
                stream.recv_window += stream._unacked
                stream._unacked = 0
        if out:
            self.writer.write(out)

    def _wake_windows(self) -> None:
        waiters, self._window_waiters = self._window_waiters, []
        for f in waiters:
            if not f.done():
                f.set_result(None)

    def _wake_slots(self) -> None:
        waiters, self._slot_waiters = self._slot_waiters, []
        for f in waiters:
            if not f.done():
                f.set_result(None)

    # --------------------------------------------------------- receive

    def _stream_for(self, sid: int) -> Stream | None:
        """The open stream ``sid``; ``None`` for a closed one; a frame on
        a stream never opened is a connection error."""
        s = self.streams.get(sid)
        if s is None:
            opened_by_us = (sid % 2 == 1) == self.client
            last = self._next_id - 2 if opened_by_us else self._last_peer_id
            if sid > last:
                raise H2Error(PROTOCOL_ERROR, f"frame on idle stream {sid}")
        return s

    @staticmethod
    def _unpad(flags: int, payload: bytes) -> bytes:
        if not flags & PADDED:
            return payload
        if not payload or payload[0] >= len(payload):
            raise H2Error(PROTOCOL_ERROR, "padding exceeds the frame")
        return payload[1:len(payload) - payload[0]]

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise H2Error(PROTOCOL_ERROR, "DATA on stream 0")
        n = len(payload)
        self.recv_window -= n
        if self.recv_window < 0:
            raise H2Error(FLOW_CONTROL_ERROR, "connection window exceeded")
        data = self._unpad(flags, payload)
        stream = self._stream_for(sid)
        if stream is None or stream.ended:
            # a stream this side reset or closed: its data is dropped
            self._consumed(None, n)
            if stream is not None:
                self._reset(stream, STREAM_CLOSED, remote=False)
            return
        stream.recv_window -= n
        if stream.recv_window < 0:
            self._consumed(None, n)
            self._reset(stream, FLOW_CONTROL_ERROR, remote=False)
            return
        self._consumed(None, n - len(data))       # padding: at once
        if data:
            stream._chunks.append(data)
        if flags & END_STREAM:
            stream.ended = True
            self._maybe_forget(stream)
        stream._wake()

    def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise H2Error(PROTOCOL_ERROR, "HEADERS on stream 0")
        body = self._unpad(flags, payload)
        if flags & PRIORITY_FLAG:
            if len(body) < 5:
                raise H2Error(FRAME_SIZE_ERROR, "short PRIORITY fields")
            body = body[5:]
        if flags & END_HEADERS:
            self._header_block(sid, flags, body)
        else:
            self._continuation = (sid, flags, [body], len(body))

    def _on_continuation(self, flags: int, sid: int, payload: bytes) -> None:
        if self._continuation is None:
            raise H2Error(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        csid, cflags, parts, size = self._continuation
        size += len(payload)
        if size > MAX_HEADER_BLOCK:
            raise H2Error(PROTOCOL_ERROR, "header block too large")
        parts.append(payload)
        if flags & END_HEADERS:
            self._continuation = None
            self._header_block(csid, cflags, b"".join(parts))
        else:
            self._continuation = (csid, cflags, parts, size)

    def _header_block(self, sid: int, flags: int, block: bytes) -> None:
        try:
            # decoded whatever the stream's state: the table must follow
            headers = self.decoder.decode(block)
        except HPACKError as e:
            raise H2Error(COMPRESSION_ERROR, str(e)) from e
        end = bool(flags & END_STREAM)
        stream = self.streams.get(sid)
        if stream is None:
            if self.client or sid % 2 == 0:
                self._stream_for(sid)        # raises for an idle stream
                return
            if sid <= self._last_peer_id:
                return                       # closed: trailers after a reset
            self._last_peer_id = sid
            stream = Stream(self, sid)
            stream.headers.set_result(headers)
            stream.ended = end
            if self.goaway_sent:
                self._write(encode_frame(RST_STREAM, 0, sid, struct.pack(
                    ">I", REFUSED_STREAM)))
                return
            self.streams[sid] = stream
            if self.on_stream is not None:
                self.on_stream(stream)
            return
        if stream.ended:
            self._reset(stream, STREAM_CLOSED, remote=False)
            return
        if not stream.headers.done():
            stream.headers.set_result(headers)
        elif end:
            stream.trailers = headers
        else:
            self._reset(stream, PROTOCOL_ERROR, remote=False)
            return
        if end:
            stream.ended = True
            self._maybe_forget(stream)
        stream._wake()

    def _on_priority(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise H2Error(PROTOCOL_ERROR, "PRIORITY on stream 0")
        if len(payload) != 5:
            raise H2Error(FRAME_SIZE_ERROR, "PRIORITY of the wrong size")

    def _on_rst_stream(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise H2Error(PROTOCOL_ERROR, "RST_STREAM on stream 0")
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "RST_STREAM of the wrong size")
        stream = self._stream_for(sid)
        if stream is not None:
            (code,) = struct.unpack(">I", payload)
            self._reset(stream, code, remote=True)

    def _on_settings(self, flags: int, sid: int, payload: bytes) -> None:
        if sid != 0:
            raise H2Error(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & ACK:
            if payload:
                raise H2Error(FRAME_SIZE_ERROR, "SETTINGS ACK with payload")
            return
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "SETTINGS of the wrong size")
        for off in range(0, len(payload), 6):
            key, value = struct.unpack_from(">HI", payload, off)
            if key == SETTINGS_INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise H2Error(FLOW_CONTROL_ERROR,
                                  "initial window above 2^31-1")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for s in self.streams.values():
                    s.send_window += delta
                    if s.send_window > MAX_WINDOW:
                        raise H2Error(FLOW_CONTROL_ERROR,
                                      "stream window above 2^31-1")
            elif key == SETTINGS_MAX_FRAME_SIZE:
                if not DEFAULT_MAX_FRAME <= value <= MAX_FRAME_LIMIT:
                    raise H2Error(PROTOCOL_ERROR,
                                  f"max frame size {value}")
                self.peer_max_frame = value
            elif key == SETTINGS_MAX_CONCURRENT_STREAMS:
                self.peer_max_streams = value
            elif key == SETTINGS_ENABLE_PUSH:
                if value > 1:
                    raise H2Error(PROTOCOL_ERROR, f"enable push {value}")
            # the header table size bounds an encoder's table, and this
            # one keeps none; unknown ids are ignored
        self._write(encode_frame(SETTINGS, ACK, 0))
        self._wake_windows()
        self._wake_slots()

    def _on_push(self, flags: int, sid: int, payload: bytes) -> None:
        raise H2Error(PROTOCOL_ERROR, "PUSH_PROMISE with push disabled")

    def _on_ping(self, flags: int, sid: int, payload: bytes) -> None:
        if sid != 0:
            raise H2Error(PROTOCOL_ERROR, "PING on a stream")
        if len(payload) != 8:
            raise H2Error(FRAME_SIZE_ERROR, "PING of the wrong size")
        if not flags & ACK:                  # this side sends no PING
            self._write(encode_frame(PING, ACK, 0, payload))

    def _on_goaway(self, flags: int, sid: int, payload: bytes) -> None:
        if sid != 0:
            raise H2Error(PROTOCOL_ERROR, "GOAWAY on a stream")
        if len(payload) < 8:
            raise H2Error(FRAME_SIZE_ERROR, "short GOAWAY")
        last, code = struct.unpack_from(">II", payload)
        last &= 0x7FFFFFFF
        self.goaway_received = (last, code)
        for s in list(self.streams.values()):
            if (s.id % 2 == 1) == self.client and s.id > last:
                # never processed: safe to retry on a new connection
                self._reset(s, REFUSED_STREAM, remote=True)
        if not self.streams:
            self._end("the peer sent GOAWAY")
        self._wake_slots()

    def _on_window_update(self, flags: int, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "WINDOW_UPDATE of the wrong size")
        (inc,) = struct.unpack(">I", payload)
        inc &= 0x7FFFFFFF
        if sid == 0:
            if inc == 0:
                raise H2Error(PROTOCOL_ERROR, "window increment of 0")
            self.send_window += inc
            if self.send_window > MAX_WINDOW:
                raise H2Error(FLOW_CONTROL_ERROR,
                              "connection window above 2^31-1")
        else:
            stream = self._stream_for(sid)
            if stream is None:
                return
            if inc == 0:
                self._reset(stream, PROTOCOL_ERROR, remote=False)
                return
            stream.send_window += inc
            if stream.send_window > MAX_WINDOW:
                self._reset(stream, FLOW_CONTROL_ERROR, remote=False)
                return
        self._wake_windows()
