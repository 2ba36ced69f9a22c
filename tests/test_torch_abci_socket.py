"""The port's out-of-process application surface against the JAX
package's, on the CPU: ``abci/client.py``'s frames (``read_frame``,
``write_frame``) equal the JAX package's bytes; a port ``SocketClient``
against a JAX ``ABCIServer`` and a JAX ``SocketClient`` against a port
one (and each package against itself, over TCP and a unix socket) give
the same responses to the same calls, app errors included; a lost
server fails pending calls with ``ABCIClientError`` and an unreachable
one raises from ``socket_client_creator`` (no local fallback); and
``abci/grammar.py``'s ``check_sequence`` agrees with the JAX checker
over legal and illegal sequences, hypothesis-made ones included, with
``RecordingApp`` recording a port app's calls as the JAX one does."""

import asyncio
import base64
import dataclasses
import os
import struct
import tempfile

import msgpack
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cometbft_tpu.abci import client as JC
from cometbft_tpu.abci import grammar as JG
from cometbft_tpu.abci import server as JS
from cometbft_tpu.abci import types as JA
from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
from cometbft_tpu_torch.abci import client as PC
from cometbft_tpu_torch.abci import grammar as PG
from cometbft_tpu_torch.abci import server as PS
from cometbft_tpu_torch.abci import types as PA
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as PApp
from cometbft_tpu_torch.proxy.multi_app_conn import (AppConns,
                                                     socket_client_creator)

pytestmark = pytest.mark.timeout(60)

PKGS = {"jax": (JC, JS, JA, JApp), "port": (PC, PS, PA, PApp)}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _norm(x):
    """A response as plain data (the packages' dataclasses have the same
    fields in the same order)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def _app(pkg):
    return JApp() if pkg == "jax" else PApp(device="cpu")


def _txs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 7 == 3:
            pk = rng.integers(0, 256, 32, np.uint8).tobytes()
            out.append(b"val:" + base64.b64encode(pk) + b"!%d"
                       % int(rng.integers(1, 20)))
        elif i % 11 == 5:
            out.append(b"no-equals-sign")
        else:
            v = rng.integers(0, 256, int(rng.integers(1, 30)),
                             np.uint8).tobytes().replace(b"=", b"+")
            out.append(b"k%d=" % int(rng.integers(0, 9)) + v)
    return out


async def _script(cli, A, seed: int):
    """One node's calls: handshake, three heights with txs, queries,
    snapshots and an unknown method."""
    out = [await cli.echo("hello"), await cli.info()]
    out.append(await cli.init_chain(A.InitChainRequest(
        chain_id="sock", initial_height=1, time_ns=1_700_000_000 * 10**9)))
    for h in range(1, 4):
        txs = _txs(seed + h, 8)
        out.append([await cli.check_tx(tx) for tx in txs])
        prep = await cli.prepare_proposal(A.PrepareProposalRequest(
            max_tx_bytes=1 << 20, txs=txs, height=h,
            time_ns=1_700_000_000 * 10**9 + h))
        out.append(prep)
        out.append(await cli.process_proposal(A.ProcessProposalRequest(
            txs=prep.txs, height=h, time_ns=1_700_000_000 * 10**9 + h)))
        out.append(await cli.finalize_block(A.FinalizeBlockRequest(
            txs=prep.txs, height=h, time_ns=1_700_000_000 * 10**9 + h,
            hash=bytes([h]) * 32)))
        out.append(await cli.commit())
    out.append(await cli.query("/key", b"k3", 0, True))
    out.append(await cli.query("/key", b"absent", 0, False))
    out.append(await cli.info())
    out.append(await cli.list_snapshots())
    try:
        await cli.call("bogus_method")
        out.append("no error")
    except Exception as e:          # both packages' ABCIClientError
        out.append((type(e).__name__, str(e)))
    return _norm(out)


async def _serve_and_call(server_pkg, client_pkg, unix_dir=None, seed=5):
    _, S, _, _ = PKGS[server_pkg]
    C, _, A, _ = PKGS[client_pkg]
    path = os.path.join(unix_dir, "abci.sock") if unix_dir else None
    server = S.ABCIServer(_app(server_pkg), port=0, unix_path=path)
    await server.start()
    cli = await C.SocketClient.connect("127.0.0.1", server.port,
                                       unix_path=path)
    try:
        return await _script(cli, A, seed)
    finally:
        await cli.close()
        await server.stop()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_socket_client_server_cross_package(server_pkg):
    """Either client against a server of ``server_pkg``: the same
    responses to every call, and the same as the port's local client."""
    outs = {c: run(_serve_and_call(server_pkg, c)) for c in ("jax", "port")}
    assert outs["jax"] == outs["port"]

    async def local():
        return await _script(PC.LocalClient(PApp(device="cpu")), PA, 5)

    if server_pkg == "port":
        # the error's text differs: the server sends the exception's repr
        assert run(local())[:-1] == outs["port"][:-1]
    err = outs["port"][-1]
    assert err[0] == "ABCIClientError" and "bogus_method" in err[1]


def test_socket_apps_of_both_packages_agree():
    """The JAX app behind a JAX server and the port app behind a port
    server answer alike (the kvstore parity, over sockets)."""
    assert run(_serve_and_call("jax", "port", seed=9)) == \
        run(_serve_and_call("port", "jax", seed=9))


def test_unix_socket_cross_package():
    with tempfile.TemporaryDirectory() as d:
        a = run(_serve_and_call("jax", "port", unix_dir=d))
    with tempfile.TemporaryDirectory() as d:
        b = run(_serve_and_call("port", "jax", unix_dir=d))
    assert a == b


def test_frames_are_the_jax_bytes():
    """``write_frame`` writes ``>I`` + ``msgpack.packb`` of the encoded
    value, and ``read_frame`` reads the JAX package's frames."""
    req = PA.FinalizeBlockRequest(txs=[b"a=1", b"b"], height=4, time_ns=7,
                                  hash=b"\x01" * 32, misbehavior=[
                                      PA.Misbehavior("DUPLICATE_VOTE",
                                                     b"\x02" * 20, 10, 3,
                                                     5, 40)])
    jreq = JA.FinalizeBlockRequest(txs=[b"a=1", b"b"], height=4, time_ns=7,
                                   hash=b"\x01" * 32, misbehavior=[
                                       JA.Misbehavior("DUPLICATE_VOTE",
                                                      b"\x02" * 20, 10, 3,
                                                      5, 40)])
    frame = {"id": 3, "method": "finalize_block",
             "params": PC._encode_value({"req": req})}
    jframe = {"id": 3, "method": "finalize_block",
              "params": JC._encode_value({"req": jreq})}

    class _W:
        def __init__(self):
            self.buf = b""

        def write(self, b):
            self.buf += b

    pw, jw = _W(), _W()
    PC.write_frame(pw, frame)
    JC.write_frame(jw, jframe)
    assert pw.buf == jw.buf
    raw = msgpack.packb(jframe, use_bin_type=True)
    assert pw.buf == struct.pack(">I", len(raw)) + raw

    async def read_back():
        r = asyncio.StreamReader()
        r.feed_data(jw.buf + pw.buf)
        r.feed_eof()
        a = await PC.read_frame(r)
        b = await JC.read_frame(r)
        return a, b

    a, b = run(read_back())
    assert a == b
    back = PC._decode_value(a["params"]["req"])
    assert isinstance(back, PA.FinalizeBlockRequest) and back == req


def test_lost_server_fails_calls_and_no_fallback():
    """A server that hangs up with a call pending fails it, and every
    later call, with ``ABCIClientError`` in both packages; a creator with
    nothing listening raises at ``AppConns.start``."""
    async def hang_up(reader, writer):
        await JC.read_frame(reader)          # read the call, never answer
        writer.close()

    async def main(C):
        server = await asyncio.start_server(hang_up, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        cli = await C.SocketClient.connect("127.0.0.1", port)
        errs = []
        for _ in range(2):
            try:
                await asyncio.wait_for(cli.echo("x"), 5)
            except C.ABCIClientError as e:
                errs.append(str(e))
        await cli.close()
        server.close()
        await server.wait_closed()
        conns = AppConns(socket_client_creator("127.0.0.1", port))
        with pytest.raises(OSError):
            await conns.start()
        return errs

    j, p = run(main(JC)), run(main(PC))
    assert j == p and len(p) == 2 and "connection lost" in p[0]


# ------------------------------------------------------------- the grammar

LEGAL = [
    ["init_chain", "prepare_proposal", "process_proposal",
     "finalize_block", "commit", "process_proposal", "finalize_block",
     "commit"],
    ["offer_snapshot", "apply_snapshot_chunk", "apply_snapshot_chunk",
     "process_proposal", "finalize_block", "commit"],
    ["finalize_block", "commit"],
    ["info", "init_chain", "check_tx", "finalize_block", "query", "commit"],
    ["offer_snapshot", "apply_snapshot_chunk", "offer_snapshot",
     "apply_snapshot_chunk", "finalize_block", "commit"],
    [],
]
ILLEGAL = [
    ["init_chain", "commit"],
    ["finalize_block", "finalize_block"],
    ["init_chain", "prepare_proposal", "commit"],
    ["init_chain", "finalize_block", "commit", "offer_snapshot"],
    ["init_chain", "init_chain"],
    ["finalize_block", "commit", "apply_snapshot_chunk"],
]


def _check(G, seq):
    try:
        return ("ok", G.check_sequence(seq))
    except G.GrammarError as e:
        return ("error", e.pos, str(e))


@pytest.mark.parametrize("seq", LEGAL + ILLEGAL)
def test_check_sequence_agrees(seq):
    j, p = _check(JG, seq), _check(PG, seq)
    assert j == p
    assert (j[0] == "ok") == (seq in LEGAL)


CALLS = sorted(JG._SEQUENCED | JG._FREE)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.sampled_from(CALLS), max_size=40))
def test_check_sequence_agrees_on_made_sequences(seq):
    assert _check(JG, seq) == _check(PG, seq)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.lists(st.sampled_from(
    ["prepare_proposal", "process_proposal", "extend_vote",
     "verify_vote_extension", "check_tx", "query"]), max_size=5),
    min_size=1, max_size=8), st.booleans())
def test_made_legal_heights_agree(heights, statesync):
    """Sequences built from the grammar: every one is legal in both."""
    seq = ["offer_snapshot", "apply_snapshot_chunk"] if statesync \
        else ["init_chain"]
    for h in heights:
        seq += h + ["finalize_block", "commit"]
    assert _check(JG, seq) == _check(PG, seq) == ("ok", len(heights))


def test_recording_app_records_alike():
    """A ``RecordingApp`` over each package's kvstore, driven through
    the same local calls, records the same names and passes ``check``."""
    async def drive(pkg):
        C, _, A, _ = PKGS[pkg]
        G = JG if pkg == "jax" else PG
        rec = G.RecordingApp(_app(pkg))
        await _script(C.LocalClient(rec), A, 3)
        return rec.calls, rec.check()

    j, p = run(drive("jax")), run(drive("port"))
    assert j == p and p[1] == 3
    assert "check_tx" in p[0] and "echo" not in p[0]
