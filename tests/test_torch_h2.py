"""The port's HTTP/2 and HPACK (``cometbft_tpu_torch/libs/_h2.py``): frame
round trips, the Huffman code of RFC 7541 Appendix B (a complete prefix
code: its Kraft sum is exactly 1 over 257 symbols, and EOS is 30 one-bits),
the RFC's examples of Appendix C decoded through a dynamic table with
eviction, encoder/decoder round trips with size updates, and connections
over loopback sockets: a 3 MiB message through the default 65,535-byte
windows, PING answered, RST_STREAM ending one stream while the others go
on, the peer's concurrent-stream limit, padded and prioritised header
blocks split over CONTINUATION, and ignored unknown settings and frame
types.  grpcio against the port is ``tests/test_torch_grpc.py``."""

import asyncio
import struct
from fractions import Fraction

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cometbft_tpu_torch.libs import _h2


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ---------------------------------------------------------------- frames

@settings(max_examples=200, deadline=None)
@given(ftype=st.integers(0, 255), flags=st.integers(0, 255),
       sid=st.integers(0, 2**31 - 1), payload=st.binary(max_size=70_000))
def test_frame_round_trip(ftype, flags, sid, payload):
    raw = _h2.encode_frame(ftype, flags, sid, payload)
    assert len(raw) == 9 + len(payload)
    assert _h2.decode_frame_header(raw[:9]) == (len(payload), ftype, flags,
                                                sid)
    assert raw[9:] == payload


def test_frame_header_ignores_the_reserved_bit():
    raw = bytearray(_h2.encode_frame(_h2.DATA, 0, 5, b"x"))
    raw[5] |= 0x80
    assert _h2.decode_frame_header(bytes(raw[:9]))[3] == 5


# --------------------------------------------------------------- Huffman

def test_huffman_code_is_complete_and_canonical():
    codes = _h2.HUFFMAN_CODES
    assert len(codes) == 257
    assert sum(Fraction(1, 2 ** bits) for _, bits in codes) == 1
    assert codes[256] == (2 ** 30 - 1, 30)            # EOS: 30 one-bits
    assert all(code < 2 ** bits for code, bits in codes)
    order = sorted(range(257), key=lambda s: (codes[s][1], s))
    code, prev = 0, codes[order[0]][1]
    for i, s in enumerate(order):
        bits = codes[s][1]
        if i:
            code = (code + 1) << (bits - prev)
        prev = bits
        assert codes[s][0] == code, s


# RFC 7541 Appendix C.4 and C.6: strings and their Huffman codes
RFC_HUFFMAN = {
    b"www.example.com": "f1e3c2e5f23a6ba0ab90f4ff",
    b"no-cache": "a8eb10649cbf",
    b"custom-key": "25a849e95ba97d7f",
    b"custom-value": "25a849e95bb8e8b4bf",
    b"302": "6402",
    b"307": "640eff",
    b"private": "aec3771a4b",
    b"Mon, 21 Oct 2013 20:13:21 GMT":
        "d07abe941054d444a8200595040b8166e082a62d1bff",
    b"https://www.example.com": "9d29ad171863c78f0b97c8e9ae82ae43d3",
    b"gzip": "9bd9ab",
    b"foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1":
        "94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f9587"
        "316065c003ed4ee5b1063d5007",
}


@pytest.mark.parametrize("text", list(RFC_HUFFMAN), ids=lambda t: t[:12])
def test_huffman_matches_the_rfc_examples(text):
    assert _h2.huffman_encode(text).hex() == RFC_HUFFMAN[text]
    assert _h2.huffman_decode(bytes.fromhex(RFC_HUFFMAN[text])) == text


@settings(max_examples=300, deadline=None)
@given(st.binary(max_size=300))
def test_huffman_round_trip(data):
    assert _h2.huffman_decode(_h2.huffman_encode(data)) == data


@pytest.mark.parametrize("raw", [
    b"\xff\xff\xff\xff",           # EOS inside the string
    b"\x00\x00",                   # padding of zeros ('0' is 00000)
    bytes.fromhex("f1e3c2e5f23a6ba0ab90f4ff") + b"\xff",   # 8 pad bits
])
def test_huffman_refuses_bad_padding_and_eos(raw):
    with pytest.raises(_h2.HPACKError):
        _h2.huffman_decode(raw)


# ----------------------------------------------------------------- HPACK

def test_integer_examples_of_the_rfc():
    # C.1.1-C.1.3
    assert _h2._encode_int(10, 5, 0) == b"\x0a"
    assert _h2._encode_int(1337, 5, 0) == b"\x1f\x9a\x0a"
    assert _h2._encode_int(42, 8, 0) == b"\x2a"
    assert _h2._decode_int(b"\x1f\x9a\x0a", 0, 5) == (1337, 3)


def _h(*pairs):
    return [(n.encode(), v.encode()) for n, v in pairs]


DATE1 = "Mon, 21 Oct 2013 20:13:21 GMT"
DATE2 = "Mon, 21 Oct 2013 20:13:22 GMT"
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
REQUESTS = [
    _h((":method", "GET"), (":scheme", "http"), (":path", "/"),
       (":authority", "www.example.com")),
    _h((":method", "GET"), (":scheme", "http"), (":path", "/"),
       (":authority", "www.example.com"), ("cache-control", "no-cache")),
    _h((":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
       (":authority", "www.example.com"), ("custom-key", "custom-value")),
]
RESPONSES = [
    _h((":status", "302"), ("cache-control", "private"), ("date", DATE1),
       ("location", "https://www.example.com")),
    _h((":status", "307"), ("cache-control", "private"), ("date", DATE1),
       ("location", "https://www.example.com")),
    _h((":status", "200"), ("cache-control", "private"), ("date", DATE2),
       ("location", "https://www.example.com"),
       ("content-encoding", "gzip"), ("set-cookie", COOKIE)),
]
# (blocks, expected headers, table size after each block, table limit)
RFC_SEQUENCES = {
    "C.3 requests": ([
        "828684410f7777772e6578616d706c652e636f6d",
        "828684be58086e6f2d6361636865",
        "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565",
    ], REQUESTS, [57, 110, 164], 4096),
    "C.4 requests, Huffman": ([
        "828684418cf1e3c2e5f23a6ba0ab90f4ff",
        "828684be5886a8eb10649cbf",
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf",
    ], REQUESTS, [57, 110, 164], 4096),
    "C.5 responses, eviction": ([
        "4803333032580770726976617465611d4d6f6e2c203231204f637420323031"
        "332032303a31333a323120474d546e1768747470733a2f2f7777772e6578616d"
        "706c652e636f6d",
        "4803333037c1c0bf",
        "88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d"
        "54c05a04677a69707738666f6f3d4153444a4b48514b425a584f5157454f5049"
        "5541585157454f49553b206d61782d6167653d333630303b2076657273696f6e"
        "3d31",
    ], RESPONSES, [222, 222, 215], 256),
    "C.6 responses, Huffman and eviction": ([
        "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a6"
        "2d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3",
        "4883640effc1c0bf",
        "88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab"
        "77ad94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f"
        "9587316065c003ed4ee5b1063d5007",
    ], RESPONSES, [222, 222, 215], 256),
}


@pytest.mark.parametrize("name", list(RFC_SEQUENCES))
def test_decoder_follows_the_rfc_examples(name):
    blocks, want, sizes, limit = RFC_SEQUENCES[name]
    dec = _h2.Decoder()
    dec.table.resize(limit)
    for block, headers, size in zip(blocks, want, sizes):
        assert dec.decode(bytes.fromhex(block)) == headers
        assert dec.table.size == size
    if limit == 256:
        # C.5.3 / C.6.3: the table after the third response
        assert list(dec.table.entries) == _h(
            ("set-cookie", COOKIE), ("content-encoding", "gzip"),
            ("date", DATE2))


class IndexingEncoder:
    """An HPACK encoder as a peer such as grpcio may be: every field not
    wholly in a table is added to its dynamic table (a literal with
    incremental indexing) and indexed when it repeats, strings are
    Huffman-coded where that is shorter (``huffman``), and a
    :meth:`resize` starts the next block with a table size update."""

    def __init__(self, huffman: bool):
        self.huffman = huffman
        self.table = _h2.HeaderTable()
        self.pending: list = []

    def resize(self, size: int) -> None:
        self.pending.append(size)

    def _str(self, s: bytes) -> bytes:
        if self.huffman:
            h = _h2.huffman_encode(s)
            if len(h) < len(s):
                return _h2._encode_int(len(h), 7, 0x80) + h
        return _h2._encode_int(len(s), 7, 0) + s

    def _find(self, name: bytes, value: bytes):
        """(index, whole field matched), index 0 for no name."""
        fields = list(_h2.STATIC_TABLE) + list(self.table.entries)
        for i, f in enumerate(fields):
            if f == (name, value):
                return i + 1, True
        names = [n for n, _ in fields]
        return (names.index(name) + 1 if name in names else 0), False

    def encode(self, headers) -> bytes:
        out = bytearray()
        for size in self.pending:
            out += _h2._encode_int(size, 5, 0x20)
            self.table.resize(size)
        self.pending.clear()
        for name, value in headers:
            i, whole = self._find(name, value)
            if whole:
                out += _h2._encode_int(i, 7, 0x80)
                continue
            out += _h2._encode_int(i, 6, 0x40)
            if not i:
                out += self._str(name)
            out += self._str(value)
            self.table.add(name, value)
        return bytes(out)


_token = st.binary(min_size=1, max_size=40)
_headers = st.lists(st.tuples(
    st.one_of(_token, st.sampled_from([n for n, _ in _h2.STATIC_TABLE])),
    st.one_of(st.binary(max_size=120),
              st.sampled_from([v for _, v in _h2.STATIC_TABLE]))),
    max_size=12)


@settings(max_examples=150, deadline=None)
@given(blocks=st.lists(st.tuples(_headers, st.one_of(
    st.none(), st.integers(0, 4096))), min_size=1, max_size=8),
       huffman=st.booleans())
def test_hpack_round_trip_through_the_dynamic_table(blocks, huffman):
    """Fields indexed into the encoder's table are decoded from the
    decoder's, through evictions and size updates; both tables stay
    equal."""
    enc = IndexingEncoder(huffman)
    dec = _h2.Decoder()
    for headers, resize in blocks:
        if resize is not None:
            enc.resize(resize)
        assert dec.decode(enc.encode(headers)) == headers
        assert list(dec.table.entries) == list(enc.table.entries)
        assert dec.table.size == enc.table.size <= enc.table.max_size


def test_encoder_indexes_only_the_static_table():
    block = _h2.encode_headers(_h((":method", "POST"), (":status", "200"),
                                  ("content-type", "application/grpc"),
                                  ("grpc-status", "0")))
    assert block[:2] == b"\x83\x88"            # both static, whole
    assert block[2] == 0x0F and block[3] == 31 - 15   # name index 31
    dec = _h2.Decoder()
    assert dec.decode(block)[3] == (b"grpc-status", b"0")
    assert not dec.table.entries


@pytest.mark.parametrize("block", [
    b"\x80",                    # index 0
    b"\xbe",                    # index 62 of an empty dynamic table
    b"\x3f\xe2\x1f",            # size update to 4,097, over the limit
    b"\x82\x20",                # size update after a field
    b"\x40\x05ab",              # truncated literal name
])
def test_decoder_refuses_bad_blocks(block):
    with pytest.raises(_h2.HPACKError):
        _h2.Decoder().decode(block)


# ------------------------------------------------------------ connections

async def _pair(window=_h2.DEFAULT_WINDOW, on_stream=None):
    """A server and a client :class:`Connection` over loopback TCP."""
    got = asyncio.get_running_loop().create_future()

    async def accept(reader, writer):
        conn = _h2.Connection(reader, writer, client=False,
                              on_stream=on_stream, window=window)
        await conn.start()
        got.set_result(conn)
        await conn.closed.wait()

    srv = await asyncio.start_server(accept, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    client = _h2.Connection(reader, writer, client=True, window=window)
    await client.start()
    server = await got
    return srv, server, client


async def _close(srv, *conns):
    for c in conns:
        await c.close()
    srv.close()
    await srv.wait_closed()


async def _read_all(stream) -> bytes:
    out = bytearray()
    while True:
        chunk = await stream.read()
        if not chunk:
            return bytes(out)
        out += chunk


def _echo_server(tasks, seen=None):
    """Each stream's data echoed back after its request headers, then
    trailers with END_STREAM."""
    async def serve(stream):
        data = await _read_all(stream)
        if seen is not None:
            seen.append((stream.id, stream.headers.result(), data))
        await stream.send_headers(_h((":status", "200")))
        await stream.send_data(data)
        await stream.send_headers(_h(("x-len", str(len(data)))),
                                  end_stream=True)

    def on_stream(stream):
        tasks.append(asyncio.create_task(serve(stream)))
    return on_stream


def test_three_mib_through_default_windows():
    """3 MiB each way through 65,535-byte stream and connection windows:
    the sender waits on WINDOW_UPDATE, never overruns a window, and the
    bytes arrive whole and in order."""
    blob = bytes(range(256)) * (3 * 4096)
    assert len(blob) == 3 << 20

    async def main():
        tasks = []
        srv, server, client = await _pair(on_stream=_echo_server(tasks))
        s = await client.open_stream(_h((":method", "POST"),
                                        (":path", "/echo")))
        await s.send_data(blob, end_stream=True)
        await s.headers
        back = await _read_all(s)
        trailers = s.trailers
        await asyncio.gather(*tasks)
        windows = (client.send_window, server.send_window,
                   client.recv_window, server.recv_window)
        await _close(srv, client, server)
        return back, trailers, windows

    back, trailers, windows = run(main())
    assert back == blob
    assert trailers == _h(("x-len", str(3 << 20)))
    assert all(0 <= w <= _h2.DEFAULT_WINDOW for w in windows)


async def _frames_until(reader, ftype, flags):
    """Frames read until one of ``ftype`` with ``flags``: (type, flags,
    payload) each."""
    frames = []
    while not frames or frames[-1][:2] != (ftype, flags):
        n, t, f, _ = _h2.decode_frame_header(await reader.readexactly(9))
        frames.append((t, f, await reader.readexactly(n)))
    return frames


def test_ping_answered():
    """A PING to a server connection and one to a client connection, as
    grpcio's core sends them to probe bandwidth, come back as ACKs with
    their payloads."""
    async def main():
        acks = []

        async def raw_peer(reader, writer):
            # a server that pings its client
            await reader.readexactly(len(_h2.PREFACE))
            writer.write(_h2.encode_frame(_h2.SETTINGS, 0, 0) +
                         _h2.encode_frame(_h2.PING, 0, 0, b"12345678"))
            acks.append((await _frames_until(reader, _h2.PING, _h2.ACK))[-1])
            writer.close()

        srv = await asyncio.start_server(raw_peer, "127.0.0.1", 0)
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", srv.sockets[0].getsockname()[1])
        client = _h2.Connection(reader, writer, client=True)
        await client.start()
        await asyncio.wait_for(client.closed.wait(), 10)
        await client.close()
        srv.close()
        await srv.wait_closed()

        async def serve(reader, writer):
            conn = _h2.Connection(reader, writer, client=False)
            await conn.start()
            await conn.closed.wait()
            await conn.close()

        srv = await asyncio.start_server(serve, "127.0.0.1", 0)
        # a client that pings its server
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", srv.sockets[0].getsockname()[1])
        writer.write(_h2.PREFACE + _h2.encode_frame(_h2.SETTINGS, 0, 0) +
                     _h2.encode_frame(_h2.PING, 0, 0, b"pingpong"))
        acks.append((await _frames_until(reader, _h2.PING, _h2.ACK))[-1])
        writer.close()
        srv.close()
        await srv.wait_closed()
        return acks

    assert run(main()) == [(_h2.PING, _h2.ACK, b"12345678"),
                           (_h2.PING, _h2.ACK, b"pingpong")]


def test_rst_stream_ends_one_stream_while_others_go_on():
    async def main():
        tasks, seen, resets = [], [], []

        async def serve(stream):
            try:
                data = await _read_all(stream)
            except _h2.StreamReset as e:
                resets.append((stream.id, e.code, e.remote))
                return
            seen.append(stream.id)
            await stream.send_headers(_h((":status", "200")))
            await stream.send_data(data, end_stream=True)

        def on_stream(stream):
            tasks.append(asyncio.create_task(serve(stream)))

        srv, server, client = await _pair(on_stream=on_stream)
        streams = [await client.open_stream(_h((":path", f"/{i}")))
                   for i in range(3)]
        await streams[1].send_data(b"partial")
        streams[1].reset(_h2.CANCEL)
        with pytest.raises(_h2.StreamReset):
            await streams[1].read()
        with pytest.raises(_h2.StreamReset):
            await streams[1].send_data(b"more")
        out = []
        for i in (0, 2):
            await streams[i].send_data(b"body%d" % i, end_stream=True)
            await streams[i].headers
            out.append(await _read_all(streams[i]))
        await asyncio.gather(*tasks)
        alive = (server.error, client.error, len(client.streams))
        await _close(srv, client, server)
        return out, seen, resets, alive

    out, seen, resets, alive = run(main())
    assert out == [b"body0", b"body2"]
    assert seen == [1, 5]
    assert resets == [(3, _h2.CANCEL, True)]
    assert alive == (None, None, 0)


def test_peer_concurrent_stream_limit():
    async def main():
        tasks = []
        srv, server, client = await _pair(on_stream=_echo_server(tasks))
        server.writer.write(_h2.encode_frame(_h2.SETTINGS, 0, 0, struct.pack(
            ">HI", _h2.SETTINGS_MAX_CONCURRENT_STREAMS, 1)))

        async def limited():
            while client.peer_max_streams != 1:
                await asyncio.sleep(0.01)

        await asyncio.wait_for(limited(), 10)
        first = await client.open_stream(_h((":path", "/a")))
        second = asyncio.create_task(client.open_stream(_h((":path",
                                                            "/b"))))
        await asyncio.sleep(0.2)
        waiting = not second.done()
        await first.send_data(b"a", end_stream=True)
        await _read_all(first)
        s2 = await second
        await s2.send_data(b"b", end_stream=True)
        await s2.headers
        got = await _read_all(s2)
        await asyncio.gather(*tasks)
        await _close(srv, client, server)
        return waiting, client.peer_max_streams, got

    assert run(main()) == (True, 1, b"b")


def test_padded_priority_headers_with_continuation_and_padded_data():
    """Raw frames into a server connection: a padded, prioritised
    HEADERS frame whose block ends in a CONTINUATION, a padded DATA
    frame, SETTINGS with an unknown id, and a frame of an unknown type
    (ignored); the server answers PING and acknowledges SETTINGS."""
    async def main():
        got = asyncio.get_running_loop().create_future()

        def on_stream(stream):
            async def take():
                got.set_result((stream.headers.result(),
                                await _read_all(stream)))
            tasks.append(asyncio.create_task(take()))

        tasks = []
        conns = []

        async def accept(reader, writer):
            conn = _h2.Connection(reader, writer, client=False,
                                  on_stream=on_stream)
            conns.append(conn)
            await conn.start()
            await conn.closed.wait()

        srv = await asyncio.start_server(accept, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        headers = _h((":method", "POST"), (":path", "/raw"),
                     ("x-long", "v" * 100))
        block = IndexingEncoder(huffman=True).encode(headers)
        pad = 7
        first = bytes([pad]) + struct.pack(">IB", 0, 15) + block[:10] + \
            b"\0" * pad
        out = _h2.PREFACE
        out += _h2.encode_frame(_h2.SETTINGS, 0, 0, struct.pack(
            ">HIHI", 0xFE03, 1, _h2.SETTINGS_MAX_FRAME_SIZE, 1 << 15))
        out += _h2.encode_frame(0xEE, 0, 0, b"unknown type")
        out += _h2.encode_frame(_h2.HEADERS,
                                _h2.PADDED | _h2.PRIORITY_FLAG, 1, first)
        out += _h2.encode_frame(_h2.CONTINUATION, _h2.END_HEADERS, 1,
                                block[10:])
        out += _h2.encode_frame(_h2.DATA, _h2.PADDED | _h2.END_STREAM, 1,
                                b"\x03body\0\0\0")
        out += _h2.encode_frame(_h2.PING, 0, 0, b"abcdefgh")
        writer.write(out)
        await writer.drain()
        seen = await got
        frames = await _frames_until(reader, _h2.PING, _h2.ACK)
        writer.close()
        await asyncio.gather(*tasks)
        peer_frame = conns[0].peer_max_frame
        srv.close()
        await srv.wait_closed()
        return seen, frames, peer_frame

    (headers, body), frames, peer_frame = run(main())
    assert headers == _h((":method", "POST"), (":path", "/raw"),
                         ("x-long", "v" * 100))
    assert body == b"body"
    assert frames[0][0] == _h2.SETTINGS and not frames[0][1] & _h2.ACK
    assert (_h2.SETTINGS, _h2.ACK, b"") in frames
    assert frames[-1] == (_h2.PING, _h2.ACK, b"abcdefgh")
    assert peer_frame == 1 << 15


def test_frame_on_an_idle_stream_is_a_connection_error():
    async def main():
        srv, server, client = await _pair()
        client.writer.write(_h2.encode_frame(_h2.DATA, 0, 41, b"x"))
        await asyncio.wait_for(server.closed.wait(), 10)
        await asyncio.wait_for(client.closed.wait(), 10)
        why = server.error
        await _close(srv, client, server)
        return why

    assert "idle stream 41" in run(main())
