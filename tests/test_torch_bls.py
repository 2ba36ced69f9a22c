"""The port's host BLS12-381 library against the JAX package's, byte for
byte, on keys made from secrets drawn with numpy from a fixed seed.

The port builds its own copy of the C++ library with ``g++`` at first use
(``cometbft_tpu_torch/native.py``) and derives keys with its own HKDF;
the JAX package uses its native backend.  Every output must be equal
bytes and every verdict equal, rejections included: a bad signature, a
wrong message, a public key off the prime-order subgroup, and malformed
encodings."""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _bls12381_py as JPY
from cometbft_tpu.crypto import bls12381 as JB
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import bls12381 as TB
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(2025)
    return [TB.Bls12381PrivKey.from_secret(rng.bytes(12)) for _ in range(8)]


def _off_subgroup_key(rng) -> bytes:
    """A compressed point on y^2 = x^3 + 4 outside the order-r subgroup."""
    while True:
        x = int.from_bytes(rng.bytes(48), "big") % JPY.P
        y2 = (x ** 3 + 4) % JPY.P
        y = pow(y2, (JPY.P + 1) // 4, JPY.P)
        if y * y % JPY.P == y2 and not JPY.g1_in_subgroup((x, y)):
            return JPY.g1_compress((x, y))


def test_library_builds_and_reports(keys, tmp_path, monkeypatch):
    """The library loads (built here or before: its build time is
    recorded either way); a source that does not compile raises with the
    compiler's output."""
    keys[0].pub_key()
    assert native.BUILD_SECONDS.get("bls12381") is not None
    assert native.lib_path("bls12381").exists()
    (tmp_path / "broken.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "HOST_SRC", tmp_path)
    monkeypatch.setattr(native, "ROOT", tmp_path)
    with pytest.raises(native.NativeBuildError, match="broken"):
        native.load("broken")
    assert "broken" not in native.BUILD_SECONDS


def test_keygen_and_public_keys_match_jax():
    rng = np.random.default_rng(11)
    for _ in range(6):
        ikm = rng.bytes(int(rng.integers(32, 80)))
        info = rng.bytes(int(rng.integers(0, 9)))
        assert TB.keygen(ikm, info) == JPY.keygen(ikm, info)
    with pytest.raises(ValueError):
        TB.keygen(b"short")
    for _ in range(6):
        secret = rng.bytes(int(rng.integers(1, 40)))
        t = TB.Bls12381PrivKey.from_secret(secret)
        j = JB.Bls12381PrivKey.from_secret(secret)
        assert t.bytes() == j.bytes()
        assert t.pub_key().bytes() == j.pub_key().bytes()
        assert t.pub_key().address() == j.pub_key().address()
        sk = int.from_bytes(t.bytes(), "big")
        assert TB.sk_to_pk(sk) == JB._BACKEND.sk_to_pk(sk)


def test_sign_verify_and_rejections_match_jax(keys):
    rng = np.random.default_rng(12)
    off = _off_subgroup_key(rng)
    for k in keys[:4]:
        jk = JB.Bls12381PrivKey(k.bytes())
        msg = rng.bytes(int(rng.integers(0, 200)))
        sig = k.sign(msg)
        assert sig == jk.sign(msg)
        pk, jpk = k.pub_key(), jk.pub_key()
        bad = bytearray(sig)
        bad[50] ^= 4
        cases = [(msg, sig), (msg + b"!", sig), (msg, bytes(bad)),
                 (msg, sig[:95]), (msg, bytes(96))]
        for m, s in cases:
            assert pk.verify_signature(m, s) == jpk.verify_signature(m, s)
        assert pk.verify_signature(msg, sig)
        assert not pk.verify_signature(msg + b"!", sig)
        for raw in (off, b"\x00" * 48, b"\xc0" + bytes(47)):
            assert TB.Bls12381PubKey(raw).verify_signature(msg, sig) == \
                JB.Bls12381PubKey(raw).verify_signature(msg, sig) is False


def test_affine_tables_and_aggregates_match_jax(keys):
    rng = np.random.default_rng(13)
    pks = [k.pub_key().bytes() for k in keys]
    aff = [TB.pk_to_affine(p) for p in pks]
    assert aff == [JB.pk_to_affine(p) for p in pks]
    for raw in (_off_subgroup_key(rng), b"\x00" * 48, b"\xc0" + bytes(47),
                b"\x9f" + b"\xff" * 47):
        with pytest.raises(ValueError):
            TB.pk_to_affine(raw)
        with pytest.raises(ValueError):
            JB.pk_to_affine(raw)
    assert TB.aggregate_affine(aff) == JB.aggregate_affine(aff)
    assert TB.aggregate_affine(aff[:1]) == aff[0]
    assert TB.negate_affine(aff[3]) == JB.negate_affine(aff[3])
    for pts in ([], [aff[0], TB.negate_affine(aff[0])],
                [aff[0][:48] + bytes(48)]):
        with pytest.raises(ValueError):
            TB.aggregate_affine(pts)
        with pytest.raises(ValueError):
            JB.aggregate_affine(pts)

    msg = b"the commit's zero-timestamp sign bytes"
    sigs = [k.sign(msg) for k in keys]
    agg = TB.aggregate_signatures(sigs)
    assert agg == JB.aggregate_signatures(sigs)
    assert TB.aggregate_signatures(sigs, check=False) == agg
    apk = TB.aggregate_affine(aff)
    for m, s, xy in ((msg, agg, apk), (msg + b"x", agg, apk),
                     (msg, sigs[0], apk), (msg, agg, aff[0]),
                     (msg, agg[:95], apk), (msg, agg, apk[:95])):
        assert TB.verify_aggregate_affine(xy, m, s) == \
            JB.verify_aggregate_affine(xy, m, s)
    assert TB.verify_aggregate_affine(apk, msg, agg)
    for bad in ([], [sigs[0][:95]], [bytes(96)]):
        with pytest.raises(ValueError):
            TB.aggregate_signatures(bad)
        with pytest.raises(ValueError):
            JB.aggregate_signatures(bad)


def test_one_signature_under_the_summed_secret_is_the_aggregate(keys):
    """A same-message cohort's aggregate equals one signature under the
    sum of the secrets mod r (how the 10,000-validator smoke fixture
    avoids 9,800 signatures)."""
    msg = b"same message"
    total = sum(int.from_bytes(k.bytes(), "big") for k in keys) % TB.R
    assert TB.sign(total, msg) == TB.aggregate_signatures(
        [k.sign(msg) for k in keys])


def test_proof_of_possession_matches_jax(keys):
    rng = np.random.default_rng(14)
    for k in keys[:3]:
        pop = TB.pop_prove(k.bytes())
        assert pop == JB.pop_prove(k.bytes())
        pk = k.pub_key().bytes()
        other = keys[-1].pub_key().bytes()
        bad = bytearray(pop)
        bad[10] ^= 1
        for p, q in ((pk, pop), (other, pop), (pk, bytes(bad)),
                     (_off_subgroup_key(rng), pop), (b"\x00" * 48, pop)):
            assert TB.pop_verify(p, q) == JB.pop_verify(p, q)
        assert TB.pop_verify(pk, pop) and not TB.pop_verify(other, pop)
    with pytest.raises(ValueError):
        TB.pop_prove(b"\x01" * 31)


def test_batch_verifier_routes_bls_lanes_to_the_host(keys):
    """Ed25519 lanes in one device batch, BLS lanes one by one on the
    host, the verdicts in lane order."""
    ed = Ed25519PrivKey.from_secret(b"bv-ed")
    bv = tbatch.create_batch_verifier("cpu")
    bv.add(ed.pub_key(), b"a", ed.sign(b"a"))
    bv.add(keys[0].pub_key(), b"b", keys[0].sign(b"b"))
    bv.add(keys[1].pub_key(), b"c", keys[1].sign(b"other"))
    bv.add(ed.pub_key(), b"d", ed.sign(b"x"))
    bv.add(keys[2].pub_key(), b"e", keys[2].sign(b"e"))
    assert bv.verify() == (False, [True, True, False, False, True])
