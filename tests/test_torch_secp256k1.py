"""The port's secp256k1 keys (``cometbft_tpu_torch/crypto/secp256k1.py``
over ``csrc/host/secp256k1.cpp``) against the JAX package's, on the CPU.

Keys, messages and signatures are made from numpy seeds.  Verdicts are
held against the JAX ``Secp256k1PubKey.verify_signature`` lane by lane,
on valid signatures and on every edge the verifier rejects (high S, r or
s of 0 or at least n, a key with a bad prefix or off the curve, a wrong
message, wrong lengths); keys and signatures byte for byte against the
JAX package's pure-Python signer (``cometbft_tpu/crypto/
_secp256k1_py.py``) and the RFC 6979 vectors of
``tests/test_secp256k1.py``; addresses against the JAX keys, and the
port's RIPEMD-160 against ``hashlib`` where its OpenSSL build has it.
Comparisons are exact."""

import hashlib

import numpy as np
import pytest

from cometbft_tpu.crypto import _secp256k1_py as jpy
from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import _secp256k1_py as tpy
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import secp256k1 as tsecp

pytestmark = pytest.mark.timeout(120)

N = jpy.N
P = jpy.P


def _scalars(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    out = []
    for row in rng.integers(0, 256, (n, 32), dtype=np.uint8):
        v = int.from_bytes(row.tobytes(), "big") % (N - 1) + 1
        out.append(v)
    return out


def _msgs(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(0, 300, n)]


def _jkey(d: int):
    return jsecp.Secp256k1PrivKey(d.to_bytes(32, "big"))


def _tkey(d: int):
    return tsecp.Secp256k1PrivKey(d.to_bytes(32, "big"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sign_and_pubkey_match_the_jax_signer(seed):
    for d, m in zip(_scalars(seed, 40), _msgs(seed + 100, 40)):
        r, s = jpy.sign(d, m)
        want = r.to_bytes(32, "big") + s.to_bytes(32, "big")
        assert _tkey(d).sign(m) == want == _jkey(d).sign(m)
        assert _tkey(d).pub_key().bytes() == jpy.pubkey_from_scalar(d)
        assert _tkey(d).pub_key().bytes() == _jkey(d).pub_key().bytes()


def test_rfc6979_vectors():
    one = _tkey(1)
    assert one.sign(b"Satoshi Nakamoto").hex() == (
        "934b1ea10a4b3c1757e2b0c017d0b6143ce3c9a7e6a4a49860d7a6ab210ee3d8"
        "2442ce9d2b916064108014783e923ec36b49743e2ffa1c4496f01a512aafd9e5")
    assert one.sign(b"All those moments will be lost in time, like tears "
                    b"in rain. Time to die...").hex() == (
        "8600dbd41e348fe5c9465ab92d23e3db8b98b873beecd930736488696438cb6b"
        "547fe64427496db33bf66019dacbf0039c04199abb0122918601db38a72cfc21")
    assert _tkey(N - 1).sign(b"Satoshi Nakamoto").hex() == (
        "fd567d121db66e382991534ada77a6bd3106f0a1098c231e47993447cd6af2d0"
        "6b39cd0eb1bc8603e159ef5c20a5c8ad685a45b06ce9bebed3f153d10d93bed5")


def test_from_secret_and_addresses_match_jax():
    for i in range(20):
        secret = b"stress%d" % i
        t = tsecp.Secp256k1PrivKey.from_secret(secret)
        j = jsecp.Secp256k1PrivKey.from_secret(secret)
        assert t.bytes() == j.bytes()
        assert t.pub_key().bytes() == j.pub_key().bytes()
        assert t.pub_key().address() == j.pub_key().address()
        assert t.sign(b"m%d" % i) == j.sign(b"m%d" % i)


def test_ripemd160_matches_hashlib():
    try:
        hashlib.new("ripemd160")
    except ValueError:
        pytest.skip("this hashlib's OpenSSL build has no RIPEMD-160")
    rng = np.random.default_rng(7)
    for n in list(range(0, 130)) + [1000, 4096, 10_001]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native.ripemd160(data) == hashlib.new("ripemd160",
                                                     data).digest()


def _edge_lanes(seed: int):
    """(pub, msg, sig) lanes: valid ones, and every edge the verifier
    must reject."""
    ds, ms = _scalars(seed, 12), _msgs(seed + 50, 12)
    lanes = []
    for d, m in zip(ds, ms):
        k = _jkey(d)
        pub, sig = k.pub_key().bytes(), k.sign(m)
        r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:],
                                                               "big")
        lanes.append((pub, m, sig))                        # valid
        lanes.append((pub, m + b"x", sig))                 # wrong message
        lanes.append((pub, m, r.to_bytes(32, "big")
                      + (N - s).to_bytes(32, "big")))      # high S
        lanes.append((pub, m, bytes(32) + sig[32:]))       # r = 0
        lanes.append((pub, m, sig[:32] + bytes(32)))       # s = 0
        lanes.append((pub, m, N.to_bytes(32, "big") + sig[32:]))  # r = n
        lanes.append((pub, m, sig[:32] + N.to_bytes(32, "big")))  # s = n
        lanes.append((pub, m, sig[:63]))                   # short sig
        lanes.append((pub, m, sig[:32]
                      + bytes([sig[32] ^ 1]) + sig[33:]))  # tampered s
    # s = n/2 exactly is allowed; n/2 + 1 is not
    half = N // 2
    k = _jkey(ds[0])
    sig = k.sign(ms[0])
    lanes.append((k.pub_key().bytes(), ms[0],
                  sig[:32] + half.to_bytes(32, "big")))
    lanes.append((k.pub_key().bytes(), ms[0],
                  sig[:32] + (half + 1).to_bytes(32, "big")))
    return lanes


@pytest.mark.parametrize("seed", [3, 4])
def test_verify_matches_jax_on_edges(seed):
    lanes = _edge_lanes(seed)
    want = [jsecp.Secp256k1PubKey(p).verify_signature(m, s)
            for p, m, s in lanes]
    got = [tsecp.Secp256k1PubKey(p).verify_signature(m, s)
           for p, m, s in lanes]
    assert got == want
    assert any(want) and not all(want)
    lanes_out = native.secp256k1_verify_lanes(lanes).result()
    assert list(lanes_out) == want


def test_bad_keys_are_refused_alike():
    good = _jkey(5).pub_key().bytes()
    x_off = next(x for x in range(1, 100)
                 if pow((x ** 3 + 7) % P, (P - 1) // 2, P) != 1)
    bad = [b"\x04" + good[1:],                         # bad prefix
           b"\x02" + x_off.to_bytes(32, "big"),       # off the curve
           b"\x02" + P.to_bytes(32, "big"),           # x >= p
           good[:32]]                                 # short
    sig = _jkey(5).sign(b"m")
    for raw in bad:
        with pytest.raises(ValueError):
            jsecp.Secp256k1PubKey(raw)
        with pytest.raises(ValueError):
            tsecp.Secp256k1PubKey(raw)
        assert native.secp256k1_verify(raw, b"m", sig) is False
    with pytest.raises(ValueError):
        tsecp.Secp256k1PrivKey(bytes(32))
    with pytest.raises(ValueError):
        tsecp.Secp256k1PrivKey(N.to_bytes(32, "big"))
    with pytest.raises(ValueError):
        native.secp256k1_pubkey(N.to_bytes(32, "big"))


def test_registry_and_the_plain_copy():
    k = tkeys.gen_priv_key("secp256k1")
    assert k.type() == "secp256k1"
    pub = tkeys.pub_key_from_type_bytes("secp256k1", k.pub_key().bytes())
    assert pub == k.pub_key()
    again = tkeys.priv_key_from_type_bytes("secp256k1", k.bytes())
    assert again.sign(b"x") == k.sign(b"x")
    assert pub.verify_signature(b"x", k.sign(b"x"))
    d = int.from_bytes(k.bytes(), "big")
    r, s = tpy.sign(d, b"x")
    assert r.to_bytes(32, "big") + s.to_bytes(32, "big") == k.sign(b"x")
    assert tpy.verify(pub.bytes(), b"x", r, s)
    with pytest.raises(ValueError):
        tkeys.gen_priv_key("sr25519")
