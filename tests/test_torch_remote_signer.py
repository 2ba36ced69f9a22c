"""The port's remote signer (``cometbft_tpu_torch/privval/signer.py``)
against the JAX package's, on the CPU: the cases of
``tests/test_privval.py`` (the round trip, the listener and dialer
topology with a signer restart, the round-trip deadline and the
listener's reconnect and retry) run with a port node side and a JAX
signer, the reverse, and each package with itself; the same key and
the same requests give the same signatures, the same double-sign
refusals and the same timeouts, and the frames are ``msgpack``'s bytes.
A signer that never dials in raises, with no file-signer fallback."""

import asyncio
import struct

import msgpack
import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JEdPriv
from cometbft_tpu.crypto.keys import pub_key_from_type_bytes as j_pub
from cometbft_tpu.libs import failures as JF
from cometbft_tpu.libs import metrics as jm
from cometbft_tpu.privval import file as jpv
from cometbft_tpu.privval import signer as js
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.vote import Proposal as JProposal
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.libs import failures as PF
from cometbft_tpu_torch.libs import metrics as pm
from cometbft_tpu_torch.privval import file as tpv
from cometbft_tpu_torch.privval import signer as ps
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.vote import (PRECOMMIT_TYPE, PREVOTE_TYPE,
                                           Proposal, Vote)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(60)

CHAIN = "pv-chain"
PKG = {"port": dict(pv=tpv, s=ps, F=PF, m=pm, V=Vote, P=Proposal,
                    B=BlockID, H=PartSetHeader, K=Ed25519PrivKey),
       "jax": dict(pv=jpv, s=js, F=JF, m=jm, V=JVote, P=JProposal,
                   B=JBlockID, H=JPSH, K=JEdPriv)}
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port"),
         ("jax", "jax")]


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("host oracle called by the port")

    monkeypatch.setattr(ref, "verify_zip215", refuse)
    JF.reset(), PF.reset()
    yield
    JF.reset(), PF.reset()


def _filepv(pkg, tmp_path, tag=""):
    k = PKG[pkg]
    d = tmp_path / f"{pkg}{tag}"
    d.mkdir(exist_ok=True)
    pv = k["pv"].FilePV(k["K"].from_secret(b"remote-key"),
                        str(d / "key.json"), str(d / "state.json"))
    pv.save_key()
    pv._save_state()
    return pv


def _vote(pkg, pub, typ=PREVOTE_TYPE, height=5, other=False, ts=1_000):
    k = PKG[pkg]
    bid = k["B"](b"\xcc" * 32, k["H"](1, b"\xdd" * 32)) if other else \
        k["B"](b"\xaa" * 32, k["H"](1, b"\xbb" * 32))
    return k["V"](type=typ, height=height, round=0, block_id=bid,
                  timestamp_ns=ts, validator_address=pub.address(),
                  validator_index=0)


def _proposal(pkg, height=9):
    k = PKG[pkg]
    return k["P"](height=height, round=0, pol_round=-1,
                  block_id=k["B"](b"\xaa" * 32, k["H"](1, b"\xbb" * 32)),
                  timestamp_ns=123)


def _ok(pub, msg, sig):
    return j_pub(pub.type(), pub.bytes()).verify_signature(msg, sig)


async def _sequence(node_pkg, pv_node):
    """The node side's requests through ``pv_node`` (a client or a
    listener): what came back, errors as (class name, text)."""
    pub = pv_node.get_pub_key()
    out = [pub.type(), pub.bytes()]
    await pv_node.ping()
    for typ, h, other in ((PREVOTE_TYPE, 5, False),
                          (PREVOTE_TYPE, 5, True),      # double sign
                          (PRECOMMIT_TYPE, 5, False),
                          (PREVOTE_TYPE, 6, False)):
        v = _vote(node_pkg, pub, typ=typ, height=h, other=other)
        try:
            await pv_node.sign_vote(CHAIN, v, sign_extension=False)
            assert _ok(pub, v.sign_bytes(CHAIN), v.signature)
            out.append((v.signature, v.timestamp_ns))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    p = _proposal(node_pkg)
    await pv_node.sign_proposal(CHAIN, p)
    assert _ok(pub, p.sign_bytes(CHAIN), p.signature)
    out.append((p.signature, p.timestamp_ns))
    return out


@pytest.mark.parametrize("node_pkg,signer_pkg", PAIRS)
def test_client_round_trip(tmp_path, node_pkg, signer_pkg):
    """``SignerServer`` of one package, ``SignerClient`` of the other."""
    pv = _filepv(signer_pkg, tmp_path)

    async def main():
        server = PKG[signer_pkg]["s"].SignerServer(pv)
        host, port = await server.listen()
        cli = await PKG[node_pkg]["s"].SignerClient.connect(host, port)
        try:
            return await _sequence(node_pkg, cli)
        finally:
            await cli.close()
            await server.close()

    out = run(main())
    assert out[3][0] == "RemoteSignerError" and \
        "DoubleSignError" in out[3][1]
    want = run(_direct(tmp_path))
    assert out == want


async def _direct(tmp_path):
    """The same sequence on the JAX FilePV in process: the remote
    answers must be its answers (the error as the signer sends it)."""
    pv = _filepv("jax", tmp_path, tag="-direct")
    server = js.SignerServer(pv)
    host, port = await server.listen()
    cli = await js.SignerClient.connect(host, port)
    try:
        return await _sequence("jax", cli)
    finally:
        await cli.close()
        await server.close()


@pytest.mark.parametrize("node_pkg,signer_pkg", PAIRS)
def test_listener_dialer_topology_with_restart(tmp_path, node_pkg,
                                               signer_pkg):
    """The node listens, the signer dials in (``serve_dialer``); after a
    signer restart the listener re-accepts its redial and signs on."""
    pv = _filepv(signer_pkg, tmp_path)
    N, S = PKG[node_pkg]["s"], PKG[signer_pkg]["s"]

    async def main():
        listener = N.SignerListener()
        host, port = await listener.listen()
        with pytest.raises(N.RemoteSignerError):
            listener.get_pub_key()           # not connected yet
        dial = asyncio.create_task(S.serve_dialer(pv, host, port,
                                                  max_retries=5,
                                                  retry_interval=0.05))
        try:
            await listener.wait_for_signer(timeout=10)
            out = await _sequence(node_pkg, listener)
            dial.cancel()
            await asyncio.sleep(0)
            dial = asyncio.create_task(S.serve_dialer(
                pv, host, port, max_retries=5, retry_interval=0.05))
            v = _vote(node_pkg, listener.get_pub_key(), height=10)
            await listener.sign_vote(CHAIN, v, sign_extension=False)
            out.append(v.signature)
            return out
        finally:
            await listener.close()
            dial.cancel()

    outs = run(main())
    assert outs[:-1] == run(_direct(tmp_path))
    assert _ok(pv.get_pub_key(), _vote(node_pkg, pv.get_pub_key(),
                                       height=10).sign_bytes(CHAIN),
               outs[-1])


@pytest.mark.parametrize("node_pkg", ["port", "jax"])
def test_signer_that_never_dials_raises(node_pkg):
    N = PKG[node_pkg]["s"]

    async def main():
        listener = N.SignerListener(accept_timeout=0.2)
        await listener.listen()
        try:
            with pytest.raises(N.RemoteSignerError) as e:
                await listener.sign_vote(CHAIN, None, sign_extension=False)
            return str(e.value)
        finally:
            await listener.close()

    assert run(main()) == \
        "timed out waiting for the remote signer to connect"


@pytest.mark.parametrize("node_pkg,signer_pkg", PAIRS)
def test_round_trip_times_out(tmp_path, node_pkg, signer_pkg):
    """``signer.round_trip.hang`` on the node side's plane: a wedged
    signer trips the deadline with ``SignerTimeoutError`` and the
    counter; the next connection signs."""
    pv = _filepv(signer_pkg, tmp_path)
    k = PKG[node_pkg]
    F = k["F"]

    async def main():
        F.configure(enabled=True, seed=7,
                    faults=["signer.round_trip.hang:at=1:delay=30"])
        server = PKG[signer_pkg]["s"].SignerServer(pv)
        host, port = await server.listen()
        cli = await k["s"].SignerClient.connect(host, port, timeout_s=0.3)
        ctr = k["m"].counter("privval_signer_timeouts_total")
        before = ctr.value()
        try:
            with pytest.raises(k["s"].SignerTimeoutError) as e:
                await cli.sign_vote(CHAIN, _vote(node_pkg,
                                                 cli.get_pub_key()),
                                    sign_extension=False)
            assert ctr.value() == before + 1
            cli2 = await k["s"].SignerClient.connect(host, port,
                                                     timeout_s=5)
            v = _vote(node_pkg, cli2.get_pub_key())
            await cli2.sign_vote(CHAIN, v, sign_extension=False)
            await cli2.close()
            return str(e.value), v.signature, [
                (ev["site"], ev["n"]) for ev in F.events()]
        finally:
            await cli.close()
            await server.close()

    out = run(main())
    assert out[0] == "remote signer did not answer within 0.3s"
    assert out[2] == [("signer.round_trip.hang", 1)]
    assert out[1] == run(_direct(tmp_path))[2][0]


@pytest.mark.parametrize("node_pkg,signer_pkg", PAIRS)
def test_listener_timeout_reconnects_and_retries(tmp_path, node_pkg,
                                                 signer_pkg):
    pv = _filepv(signer_pkg, tmp_path)
    k = PKG[node_pkg]

    async def main():
        k["F"].configure(enabled=True, seed=7,
                         faults=["signer.round_trip.hang:at=1:delay=30"])
        listener = k["s"].SignerListener(timeout_s=0.3)
        host, port = await listener.listen()
        dial = asyncio.create_task(PKG[signer_pkg]["s"].serve_dialer(
            pv, host, port, max_retries=50, retry_interval=0.05))
        try:
            await listener.wait_for_signer(timeout=10)
            v = _vote(node_pkg, listener.get_pub_key())
            await listener.sign_vote(CHAIN, v, sign_extension=False)
            return v.signature, [e["site"] for e in k["F"].events()]
        finally:
            await listener.close()
            dial.cancel()

    sig, sites = run(main())
    assert sites == ["signer.round_trip.hang"]
    assert sig == run(_direct(tmp_path))[2][0]


def test_frames_are_msgpack_bytes():
    """The signer's frames: ``<I`` + ``msgpack.packb``, both ways."""
    class _W:
        buf = b""

        def write(self, b):
            self.buf += b

        async def drain(self):
            pass

    pub = Ed25519PrivKey.from_secret(b"f").pub_key()
    req = {"@": "sign_vote_req", "chain_id": CHAIN,
           "vote": ps.codec.to_dict(_vote("port", pub)), "ext": True}
    jreq = {"@": "sign_vote_req", "chain_id": CHAIN,
            "vote": js.codec.to_dict(_vote(
                "jax", JEdPriv.from_secret(b"f").pub_key())), "ext": True}
    pw, jw = _W(), _W()
    run(ps._send(pw, req))
    run(js._send(jw, jreq))
    raw = msgpack.packb(jreq, use_bin_type=True)
    assert pw.buf == jw.buf == struct.pack("<I", len(raw)) + raw

    async def read_back():
        r = asyncio.StreamReader()
        r.feed_data(jw.buf)
        r.feed_eof()
        return await ps._recv(r)

    assert run(read_back()) == msgpack.unpackb(raw, raw=False)
