"""The port's secret-connection crypto (``cometbft_tpu_torch/crypto/
_sc_fallback.py`` over ``csrc/host/aead.cpp``) against RFC 8439 and RFC
7748 vectors, the JAX package's ``crypto/_sc_fallback.py`` and
``cryptography``, byte for byte, on inputs made from numpy seeds; the
pure-Python cipher (the plain version) against the native library; and
a build that fails raises instead of falling back."""

import numpy as np
import pytest
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey as CxPriv, X25519PublicKey as CxPub)
from cryptography.hazmat.primitives.ciphers.aead import (
    ChaCha20Poly1305 as CxAead)

from cometbft_tpu.crypto import _sc_fallback as jsc
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import _sc_fallback as sc

KEY = bytes(range(0x80, 0xA0))
NONCE = bytes.fromhex("070000004041424344454647")
AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
      b"only one tip for the future, sunscreen would be it.")
CT = bytes.fromhex(                                # RFC 8439 §2.8.2
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
    "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
    "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116"
    "1ae10b594f09e26a7e902ecbd0600691")             # ciphertext || tag

SIZES = [0, 1, 15, 16, 17, 63, 64, 65, 255, 1022, 1024, 1040, 4099]


def _rand(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_rfc8439_vector():
    a = sc.ChaCha20Poly1305(KEY)
    assert a.encrypt(NONCE, PT, AAD) == CT
    assert a.decrypt(NONCE, CT, AAD) == PT
    assert sc.seal_plain(KEY, NONCE, PT, AAD) == CT
    assert sc.open_plain(KEY, NONCE, CT, AAD) == PT


@pytest.mark.parametrize("pos", [0, 5, len(PT) - 1, len(PT), len(PT) + 15])
def test_tamper_rejected(pos):
    """A flipped bit in the ciphertext or the tag, or a changed aad, is
    refused by the native library and the plain version alike."""
    a = sc.ChaCha20Poly1305(KEY)
    bad = bytearray(CT)
    bad[pos] ^= 1
    with pytest.raises(sc.InvalidTag):
        a.decrypt(NONCE, bytes(bad), AAD)
    assert sc.open_plain(KEY, NONCE, bytes(bad), AAD) is None
    with pytest.raises(sc.InvalidTag):
        a.decrypt(NONCE, CT, AAD[:-1])
    with pytest.raises(sc.InvalidTag):
        a.decrypt(NONCE, CT[:15], AAD)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seal_open_match_jax_cryptography_and_plain(seed):
    rng = np.random.default_rng(seed)
    for n in SIZES:
        key, nonce = _rand(rng, 32), _rand(rng, 12)
        aad = _rand(rng, int(rng.choice([0, 5, 16, 33])))
        msg = _rand(rng, n)
        ours = sc.ChaCha20Poly1305(key).encrypt(nonce, msg, aad)
        assert ours == jsc.ChaCha20Poly1305(key).encrypt(nonce, msg, aad)
        assert ours == CxAead(key).encrypt(nonce, msg, aad)
        assert ours == sc.seal_plain(key, nonce, msg, aad)
        assert sc.ChaCha20Poly1305(key).decrypt(nonce, ours, aad) == msg
        assert jsc.ChaCha20Poly1305(key).decrypt(nonce, ours, aad) == msg
        assert sc.open_plain(key, nonce, ours, aad) == msg


def test_rfc7748_vectors():
    """RFC 7748 §5.2 scalar multiplications and the §6.1 exchange."""
    for k, u, out in (
            ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
             "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
             "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
            ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
             "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
             "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957")):
        assert sc.x25519(bytes.fromhex(k), bytes.fromhex(u)).hex() == out
    alice = sc.X25519PrivateKey(bytes.fromhex(
        "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"))
    bob = sc.X25519PrivateKey(bytes.fromhex(
        "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"))
    assert alice.public_key().public_bytes_raw().hex() == \
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    assert bob.public_key().public_bytes_raw().hex() == \
        "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    shared = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    assert alice.exchange(bob.public_key()).hex() == shared
    assert bob.exchange(alice.public_key()).hex() == shared


@pytest.mark.parametrize("seed", [3, 4])
def test_x25519_matches_jax_and_cryptography(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        a, b = _rand(rng, 32), _rand(rng, 32)
        pa = sc.X25519PrivateKey(a).public_key()
        assert pa.public_bytes_raw() == \
            jsc.X25519PrivateKey(a).public_key().public_bytes_raw()
        assert pa.public_bytes_raw() == CxPriv.from_private_bytes(a) \
            .public_key().public_bytes_raw()
        pb = sc.X25519PrivateKey(b).public_key()
        shared = sc.X25519PrivateKey(a).exchange(pb)
        assert shared == CxPriv.from_private_bytes(a).exchange(
            CxPub.from_public_bytes(pb.public_bytes_raw()))
        assert shared == jsc.X25519PrivateKey(a).exchange(
            jsc.X25519PublicKey(pb.public_bytes_raw()))


def test_zero_point_exchange_refused():
    with pytest.raises(ValueError):
        sc.X25519PrivateKey(b"\x01" * 32).exchange(
            sc.X25519PublicKey.from_public_bytes(b"\x00" * 32))


def test_failed_build_raises(monkeypatch):
    """A library that does not build raises NativeBuildError at the
    first seal: the pure-Python cipher is never a quiet substitute."""
    monkeypatch.setattr(native, "_AEAD", [])
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "FLAGS",
                        native.FLAGS + ["-include", "/nonexistent.h"])
    with pytest.raises(native.NativeBuildError):
        sc.ChaCha20Poly1305(KEY).encrypt(NONCE, PT, AAD)
