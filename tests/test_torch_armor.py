"""The port's ASCII armor (``cometbft_tpu_torch/crypto/armor.py``)
against the JAX package's: a block either package encodes decodes alike
in both, byte for byte, and malformed blocks raise the same errors."""

import numpy as np
import pytest

import cometbft_tpu.crypto.armor as j_armor
import cometbft_tpu_torch.crypto.armor as t_armor

PAIRS = [(j_armor, t_armor), (t_armor, j_armor)]


@pytest.mark.parametrize("n", [0, 1, 2, 3, 47, 48, 49, 64, 200, 1000])
def test_encode_decode_both_ways(n):
    rng = np.random.default_rng(n)
    data = rng.bytes(n)
    headers = {"type": "ed25519", "kdf": "none", "Comment": f"n={n}"}
    texts = [A.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
             for A in (j_armor, t_armor)]
    assert texts[0] == texts[1]
    for enc, dec in PAIRS:
        text = enc.encode_armor("MESSAGE", headers, data)
        assert dec.decode_armor(text) == ("MESSAGE", headers, data)
        assert dec.decode_armor(text.replace("\n", "\r\n")) == (
            "MESSAGE", headers, data)
    assert t_armor._crc24(data) == j_armor._crc24(data)


def test_priv_key_armor_both_ways():
    key = bytes(range(64))
    for enc, dec in PAIRS:
        assert dec.unarmor_priv_key(enc.armor_priv_key(key, "ed25519")) == \
            (key, "ed25519")


def _bad_texts():
    good = j_armor.encode_armor("MESSAGE", {"a": "b"}, b"payload bytes")
    lines = good.splitlines()
    crc_at = next(i for i, ln in enumerate(lines) if ln.startswith("="))
    flipped = list(lines)
    flipped[crc_at] = "=" + ("AAAA" if lines[crc_at][1:] != "AAAA"
                             else "AAAB")
    return {
        "no begin": good.replace("-----BEGIN MESSAGE-----", "BEGIN"),
        "no end": good.replace("-----END MESSAGE-----", ""),
        "mismatched end": good.replace("END MESSAGE", "END OTHER"),
        "bad body": good.replace(lines[crc_at - 1], "!!!not base64!!!"),
        "bad crc": "\n".join(flipped),
        "bad crc trailer": "\n".join(
            lines[:crc_at] + ["=*"] + lines[crc_at + 1:]),
        "empty": "",
        "other block": j_armor.encode_armor("MESSAGE", {}, b"k"),
    }


@pytest.mark.parametrize("case", sorted(_bad_texts()))
def test_malformed_blocks_raise_alike(case):
    text = _bad_texts()[case]
    errs = []
    for A in (j_armor, t_armor):
        with pytest.raises(A.ArmorError) as e:
            if case == "other block":
                A.unarmor_priv_key(text)
            else:
                A.decode_armor(text)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
