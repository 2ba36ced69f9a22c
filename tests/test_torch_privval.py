"""The port's file signer (``cometbft_tpu_torch/privval/file.py``) against
the JAX package's, on the CPU: the Ed25519 and BLS cases of
``tests/test_privval.py`` on both packages side by side; the key and
state files of the same key and the same signing sequence are equal
byte for byte, and each package loads the other's (and refuses what the
other refuses), for Ed25519, secp256k1 and BLS keys; a secp256k1 key
file round-trips between the packages and an out-of-range one raises in
both; a sign-state persist failure withholds the signature and halts
consensus; and the port's in-process network commits on FilePV
signers."""

import asyncio
import errno
import json

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JEdPriv
from cometbft_tpu.crypto.keys import pub_key_from_type_bytes as j_pub
from cometbft_tpu.crypto.secp256k1 import Secp256k1PrivKey as JSecpPriv
from cometbft_tpu.privval import file as jpv
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.vote import Proposal as JProposal
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey
from cometbft_tpu_torch.libs import failures as F
from cometbft_tpu_torch.privval import file as tpv
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.vote import (PRECOMMIT_TYPE, PREVOTE_TYPE,
                                           Proposal, Vote)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)

CHAIN = "pv-chain"
PKG = {"port": (tpv, Vote, Proposal, BlockID, PartSetHeader),
       "jax": (jpv, JVote, JProposal, JBlockID, JPSH)}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _verify(pub, msg, sig):
    """Test-side check of a produced signature (the JAX package's key
    verifies; the port never verifies on the host on its paths)."""
    return j_pub(pub.type(), pub.bytes()).verify_signature(msg, sig)


def _key(pkg, key_type, secret=b"pv-key"):
    if key_type == "bls12_381":
        mod = tbls if pkg == "port" else jbls
        return mod.Bls12381PrivKey.from_secret(secret)
    if key_type == "secp256k1":
        return (Secp256k1PrivKey if pkg == "port" else
                JSecpPriv).from_secret(secret)
    return (Ed25519PrivKey if pkg == "port" else JEdPriv).from_secret(secret)


def _pv(pkg, tmp_path, key_type="ed25519", tag=""):
    mod = PKG[pkg][0]
    pv = mod.FilePV(_key(pkg, key_type), str(tmp_path / f"{pkg}{tag}-key.json"),
                    str(tmp_path / f"{pkg}{tag}-state.json"))
    pv.save_key()
    pv._save_state()
    return pv


def _vote(pkg, pv, typ=PREVOTE_TYPE, height=5, round_=0, other=False,
          ts=1_000):
    _, V, _, B, P = PKG[pkg]
    bid = B(b"\xcc" * 32, P(1, b"\xdd" * 32)) if other else \
        B(b"\xaa" * 32, P(1, b"\xbb" * 32))
    return V(type=typ, height=height, round=round_, block_id=bid,
             timestamp_ns=ts, validator_address=pv.get_pub_key().address(),
             validator_index=0)


def _proposal(pkg, height=7, other=False):
    _, _, Pr, B, P = PKG[pkg]
    bid = B(b"\xcc" * 32, P(1, b"\xdd" * 32)) if other else \
        B(b"\xaa" * 32, P(1, b"\xbb" * 32))
    return Pr(height=height, round=0, pol_round=-1, block_id=bid,
              timestamp_ns=123)


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def no_host_verify(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("host oracle called by the port")

    monkeypatch.setattr(ref, "verify_zip215", refuse)


def _files(pv):
    with open(pv.key_path, "rb") as f, open(pv.state_path, "rb") as g:
        return f.read(), g.read()


@pytest.mark.parametrize("key_type", ["ed25519", "secp256k1", "bls12_381"])
def test_files_equal_and_cross_load(tmp_path, key_type):
    """The same key and signing sequence give equal key and state files,
    and each package loads the other's files and refuses the same
    conflicting vote."""
    rng = np.random.default_rng(7)
    t, j = _pv("port", tmp_path, key_type), _pv("jax", tmp_path, key_type)
    assert _files(t) == _files(j)
    h = 3
    for _ in range(6):
        h += int(rng.integers(0, 2))
        typ = int(rng.choice([PREVOTE_TYPE, PRECOMMIT_TYPE]))
        r = int(rng.integers(0, 2))
        ts = int(rng.integers(1, 10**12))
        outs = []
        for pkg, pv in (("port", t), ("jax", j)):
            v = _vote(pkg, pv, typ=typ, height=h, round_=r, ts=ts)
            try:
                run(pv.sign_vote(CHAIN, v, sign_extension=False))
                outs.append((v.signature, v.timestamp_ns))
            except PKG[pkg][0].DoubleSignError as e:
                outs.append(("refused", str(e)))
        assert outs[0] == outs[1]
        assert _files(t)[1] == _files(j)[1]
    t2 = jpv.FilePV.load(t.key_path, t.state_path)
    j2 = tpv.FilePV.load(j.key_path, j.state_path)
    assert (t2.height, t2.round, t2.step, t2.signature) == \
        (j2.height, j2.round, j2.step, j2.signature)
    assert j2.get_pub_key().bytes() == t.get_pub_key().bytes()
    typ = PREVOTE_TYPE if j2.step == tpv.STEP_PREVOTE else PRECOMMIT_TYPE
    with pytest.raises(tpv.DoubleSignError):
        run(j2.sign_vote(CHAIN, _vote("port", j2, typ=typ, height=j2.height,
                                      round_=j2.round, other=True),
                         sign_extension=False))
    if key_type == "bls12_381":
        assert j2.pop() == t2.pop() == t.pop()


def test_generated_key_file_loads_in_jax(tmp_path):
    pv = tpv.FilePV.generate(str(tmp_path / "k.json"), str(tmp_path / "s.json"))
    j = jpv.FilePV.load(str(tmp_path / "k.json"), str(tmp_path / "s.json"))
    assert j.get_pub_key().bytes() == pv.get_pub_key().bytes()
    b = tpv.FilePV.generate(str(tmp_path / "bk.json"),
                            str(tmp_path / "bs.json"), key_type="bls12_381")
    with open(b.key_path) as f:
        kd = json.load(f)
    assert jbls.pop_verify(bytes.fromhex(kd["pub_key"]),
                           bytes.fromhex(kd["pop"]))


def test_filepv_signs_and_persists(tmp_path, pkg):
    pv = _pv(pkg, tmp_path)
    v = _vote(pkg, pv)
    run(pv.sign_vote(CHAIN, v, sign_extension=False))
    assert _verify(pv.get_pub_key(), v.sign_bytes(CHAIN), v.signature)
    pv2 = PKG[pkg][0].FilePV.load(pv.key_path, pv.state_path)
    assert (pv2.height, pv2.round, pv2.step) == (5, 0, 2)
    assert pv2.signature == v.signature


def test_filepv_same_vote_and_timestamp_only_change(tmp_path, pkg):
    pv = _pv(pkg, tmp_path)
    v1 = _vote(pkg, pv)
    run(pv.sign_vote(CHAIN, v1, sign_extension=False))
    v2 = _vote(pkg, pv)
    run(pv.sign_vote(CHAIN, v2, sign_extension=False))
    assert v2.signature == v1.signature
    v3 = _vote(pkg, pv, ts=9_999)
    run(pv.sign_vote(CHAIN, v3, sign_extension=False))
    assert v3.timestamp_ns == 1_000 and v3.signature == v1.signature


def test_filepv_refuses_conflicts_and_regressions(tmp_path, pkg):
    pv = _pv(pkg, tmp_path)
    err = PKG[pkg][0].DoubleSignError
    run(pv.sign_vote(CHAIN, _vote(pkg, pv), sign_extension=False))
    with pytest.raises(err):
        run(pv.sign_vote(CHAIN, _vote(pkg, pv, other=True),
                         sign_extension=False))
    run(pv.sign_vote(CHAIN, _vote(pkg, pv, typ=PRECOMMIT_TYPE, round_=2),
                     sign_extension=False))
    for kw in (dict(height=4), dict(height=5, round_=1),
               dict(typ=PREVOTE_TYPE, height=5, round_=2)):
        with pytest.raises(err):
            run(pv.sign_vote(CHAIN, _vote(pkg, pv, **kw),
                             sign_extension=False))


def test_filepv_survives_restart_no_double_sign(tmp_path, pkg):
    pv = _pv(pkg, tmp_path)
    run(pv.sign_vote(CHAIN, _vote(pkg, pv, typ=PRECOMMIT_TYPE),
                     sign_extension=False))
    pv2 = PKG[pkg][0].FilePV.load(pv.key_path, pv.state_path)
    with pytest.raises(PKG[pkg][0].DoubleSignError):
        run(pv2.sign_vote(CHAIN, _vote(pkg, pv2, typ=PRECOMMIT_TYPE,
                                       other=True), sign_extension=False))


def test_filepv_proposal(tmp_path, pkg):
    pv = _pv(pkg, tmp_path)
    p = _proposal(pkg)
    run(pv.sign_proposal(CHAIN, p))
    assert _verify(pv.get_pub_key(), p.sign_bytes(CHAIN), p.signature)
    run(pv.sign_vote(CHAIN, _vote(pkg, pv, height=7), sign_extension=False))
    with pytest.raises(PKG[pkg][0].DoubleSignError):
        run(pv.sign_proposal(CHAIN, _proposal(pkg, other=True)))


def test_filepv_bls_signs_aggregation_domain(tmp_path, pkg):
    pv = _pv(pkg, tmp_path, "bls12_381")
    v = _vote(pkg, pv, typ=PRECOMMIT_TYPE)
    run(pv.sign_vote(CHAIN, v, sign_extension=False))
    pub = pv.get_pub_key()
    assert len(v.signature) == 96
    assert _verify(pub, v.sign_bytes_for(CHAIN, "bls12_381"), v.signature)
    assert not _verify(pub, v.sign_bytes(CHAIN), v.signature)
    with pytest.raises(PKG[pkg][0].DoubleSignError):
        run(pv.sign_vote(CHAIN, _vote(pkg, pv, typ=PRECOMMIT_TYPE,
                                      other=True), sign_extension=False))


def test_secp256k1_key_file_raises(tmp_path):
    """A secp256k1 key file round-trips between the packages byte for
    byte (generated by either, loaded and signed with by the other); a
    file whose scalar is out of range raises ValueError in both."""
    j = jpv.FilePV.generate(str(tmp_path / "k.json"), str(tmp_path / "s.json"),
                            key_type="secp256k1")
    t = tpv.FilePV.load(str(tmp_path / "k.json"), str(tmp_path / "s.json"))
    assert t.get_pub_key().type() == "secp256k1"
    assert t.get_pub_key().bytes() == j.get_pub_key().bytes()
    assert t.get_pub_key().address() == j.get_pub_key().address()
    for pkg, pv in (("jax", j), ("port", t)):
        v = _vote(pkg, pv, typ=PRECOMMIT_TYPE)
        run(pv.sign_vote(CHAIN, v, sign_extension=False))
        assert len(v.signature) == 64
        assert _verify(pv.get_pub_key(), v.sign_bytes(CHAIN), v.signature)
    assert j.signature == t.signature
    g = tpv.FilePV.generate(str(tmp_path / "k2.json"),
                            str(tmp_path / "s2.json"), key_type="secp256k1")
    g2 = jpv.FilePV.load(g.key_path, g.state_path)
    assert g2.get_pub_key().bytes() == g.get_pub_key().bytes()
    with open(g.key_path, "rb") as f:
        raw = f.read()
    g2.save_key()
    with open(g.key_path, "rb") as f:
        assert f.read() == raw
    with open(g.key_path) as f:
        kd = json.load(f)
    kd["priv_key"] = "00" * 32
    with open(g.key_path, "w") as f:
        json.dump(kd, f)
    for mod in (tpv, jpv):
        with pytest.raises(ValueError):
            mod.FilePV.load(g.key_path, g.state_path)


def test_filepv_corrupt_state_file_raises_typed_error(tmp_path, pkg):
    pv = _pv(pkg, tmp_path)
    run(pv.sign_vote(CHAIN, _vote(pkg, pv), sign_extension=False))
    for payload in ("{not json", "", '{"height": 5, "round": 0}',
                    '{"height": "nan", "round": 0, "step": 2}'):
        with open(pv.state_path, "w") as f:
            f.write(payload)
        with pytest.raises(PKG[pkg][0].SignStateError) as ei:
            PKG[pkg][0].FilePV.load(pv.key_path, pv.state_path)
        assert "double-sign" in str(ei.value)


def test_state_fsync_eio_withholds_signature_and_halts(tmp_path):
    pv = _pv("port", tmp_path)
    F.configure(enabled=True, seed=3,
                faults=["privval.state.fsync.eio:at=1"])
    try:
        v = _vote("port", pv)
        with pytest.raises(OSError) as ei:
            run(pv.sign_vote(CHAIN, v, sign_extension=False))
        assert ei.value.errno == errno.EIO
        assert v.signature == b""
        F.reset()
        with pytest.raises(tpv.SignStateError) as e2:
            run(pv.sign_vote(CHAIN, _vote("port", pv, height=6),
                             sign_extension=False))
        # consensus treats it as fatal: the node halts, never retries
        from cometbft_tpu_torch.consensus.state import ConsensusState

        assert ConsensusState._is_fatal_io_error(
            type("S", (), {"wal": None})(), e2.value)
        pv2 = tpv.FilePV.load(pv.key_path, pv.state_path)
        v2 = _vote("port", pv2, height=6)
        run(pv2.sign_vote(CHAIN, v2, sign_extension=False))
        assert v2.signature
    finally:
        F.reset()


def test_consensus_runs_on_filepv(tmp_path):
    from cometbft_tpu_torch.testing import make_inproc_network

    async def main():
        def pv_factory(i):
            return tpv.FilePV.generate(str(tmp_path / f"k{i}.json"),
                                       str(tmp_path / f"s{i}.json"))

        vsched.set_scheduler(None)
        net = await make_inproc_network(4, device="cpu",
                                        pv_factory=pv_factory)
        try:
            await net.start()
            await net.wait_for_height(3, timeout=100)
            hashes = {n.block_store.load_block(3).hash() for n in net.nodes}
            assert len(hashes) == 1
        finally:
            await net.stop()

    run(main())
