"""The port's native Ed25519 signer (``csrc/host/ed25519_sign.cpp`` through
``native.ed25519_sign``/``ed25519_pubkey``, behind ``crypto/keys.py``)
against the port's pure-Python oracle and the JAX package's signer:
Ed25519 signatures are deterministic, so every public key and every
signature must be equal byte for byte, for seeds from numpy and messages
of 0 to 1,000 bytes.  A library that does not build raises
``NativeBuildError``, with no fallback to the Python signer."""

import numpy as np
import pytest

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as TPriv
from cometbft_tpu_torch.types.priv_validator import MockPV
from cometbft_tpu_torch.types.vote import PREVOTE_TYPE, Proposal, Vote
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader

LENGTHS = (0, 1, 31, 32, 33, 63, 64, 65, 111, 112, 127, 128, 129, 255, 500,
           999, 1000)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_signatures_match_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    secret = rng.integers(0, 256, 32, np.uint8).tobytes()
    tk = TPriv(secret)
    jk = JPriv(secret + ref.public_key_from_seed(secret))
    assert tk.pub_key().bytes() == ref.public_key_from_seed(secret)
    assert tk.pub_key().bytes() == jk.pub_key().bytes()
    for n in LENGTHS:
        msg = rng.integers(0, 256, n, np.uint8).tobytes()
        sig = tk.sign(msg)
        assert sig == ref.sign(secret, msg), n
        assert sig == jk.sign(msg), n
        assert ref.verify_zip215(tk.pub_key().bytes(), msg, sig)


def test_from_secret_keys_match_jax():
    for i in range(8):
        secret = b"inproc%d" % i
        tk, jk = TPriv.from_secret(secret), JPriv.from_secret(secret)
        assert tk.bytes() == jk.bytes()
        msg = b"vote %d" % i
        assert tk.sign(msg) == jk.sign(msg)


def test_native_entry_points_check_seed_length():
    with pytest.raises(ValueError):
        native.ed25519_sign(b"\x00" * 31, b"m")
    with pytest.raises(ValueError):
        native.ed25519_pubkey(b"\x00" * 33)
    seed = bytes(range(32))
    assert native.ed25519_pubkey(seed) == ref.public_key_from_seed(seed)
    assert native.ed25519_sign(seed, bytearray(b"x" * 70)) == \
        ref.sign(seed, b"x" * 70)


def test_mock_pv_signs_votes_and_proposals_as_jax():
    """MockPV over the native signer: vote, extension and proposal
    signatures equal the JAX package's MockPV's."""
    import asyncio

    from cometbft_tpu.types.block_id import BlockID as JBID
    from cometbft_tpu.types.block_id import PartSetHeader as JPSH
    from cometbft_tpu.types.priv_validator import MockPV as JMockPV
    from cometbft_tpu.types.vote import Proposal as JProposal
    from cometbft_tpu.types.vote import Vote as JVote

    tpv, jpv = MockPV.from_secret(b"pv-7"), JMockPV.from_secret(b"pv-7")
    assert tpv.get_pub_key().bytes() == jpv.get_pub_key().bytes()
    assert tpv.pop() == b"" and jpv.pop() == b""
    h = bytes(range(32))
    tbid = BlockID(h, PartSetHeader(2, h[::-1]))
    jbid = JBID(h, JPSH(2, h[::-1]))
    addr = tpv.get_pub_key().address()
    tv = Vote(type=2, height=5, round=1, block_id=tbid,
              timestamp_ns=1_700_000_000_123_456_789,
              validator_address=addr, validator_index=3, extension=b"ext")
    jv = JVote(type=2, height=5, round=1, block_id=jbid,
               timestamp_ns=1_700_000_000_123_456_789,
               validator_address=addr, validator_index=3, extension=b"ext")
    tp = Proposal(height=5, round=1, pol_round=0, block_id=tbid,
                  timestamp_ns=1_700_000_000_000_000_001)
    jp = JProposal(height=5, round=1, pol_round=0, block_id=jbid,
                   timestamp_ns=1_700_000_000_000_000_001)

    async def sign():
        await tpv.sign_vote("c", tv, sign_extension=True)
        await jpv.sign_vote("c", jv, sign_extension=True)
        await tpv.sign_proposal("c", tp)
        await jpv.sign_proposal("c", jp)

    asyncio.run(sign())
    assert tv.signature == jv.signature
    assert tv.extension_signature == jv.extension_signature
    assert tp.signature == jp.signature
    pv = Vote(type=PREVOTE_TYPE, height=1, round=0, block_id=BlockID(),
              timestamp_ns=1, validator_address=addr, validator_index=0)
    asyncio.run(tpv.sign_vote("c", pv, sign_extension=False))
    assert pv.extension_signature == b""
    assert ref.verify_zip215(tpv.get_pub_key().bytes(),
                             pv.sign_bytes("c"), pv.signature)


def test_failed_build_raises_and_nothing_falls_back(monkeypatch):
    monkeypatch.setattr(native, "_SIGN", [])
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "FLAGS",
                        native.FLAGS + ["-fno-such-flag-for-this-test"])
    with pytest.raises(native.NativeBuildError):
        TPriv(b"\x05" * 32)
    with pytest.raises(native.NativeBuildError):
        native.ed25519_sign(b"\x05" * 32, b"m")
