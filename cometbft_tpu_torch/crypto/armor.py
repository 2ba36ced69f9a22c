"""ASCII armor for keys and other binary payloads (counterpart of
``cometbft_tpu/crypto/armor.py``; reference: ``crypto/armor/armor.go``):
OpenPGP-style blocks with headers and a CRC-24 integrity trailer."""

from __future__ import annotations

import base64
import textwrap

_CRC24_INIT = 0xB704CE
_CRC24_POLY = 0x1864CFB


def _crc24(data: bytes) -> int:
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


class ArmorError(Exception):
    pass


def encode_armor(block_type: str, headers: dict[str, str],
                 data: bytes) -> str:
    """armor.go EncodeArmor."""
    lines = [f"-----BEGIN {block_type}-----"]
    for k, v in sorted(headers.items()):
        lines.append(f"{k}: {v}")
    lines.append("")
    body = base64.b64encode(data).decode()
    lines.extend(textwrap.wrap(body, 64) or [""])
    crc = base64.b64encode(_crc24(data).to_bytes(3, "big")).decode()
    lines.append(f"={crc}")
    lines.append(f"-----END {block_type}-----")
    return "\n".join(lines) + "\n"


def decode_armor(text: str) -> tuple[str, dict[str, str], bytes]:
    """armor.go DecodeArmor -> (block_type, headers, data)."""
    lines = [ln.rstrip("\r") for ln in text.strip().splitlines()]
    if not lines or not lines[0].startswith("-----BEGIN ") or \
            not lines[0].endswith("-----"):
        raise ArmorError("missing armor begin line")
    block_type = lines[0][len("-----BEGIN "):-len("-----")]
    if lines[-1] != f"-----END {block_type}-----":
        raise ArmorError("missing or mismatched armor end line")
    headers: dict[str, str] = {}
    i = 1
    while i < len(lines) - 1 and lines[i]:
        if ":" not in lines[i]:
            break
        k, _, v = lines[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    if i < len(lines) - 1 and not lines[i]:
        i += 1
    body_lines = []
    crc_line = None
    for ln in lines[i:-1]:
        if ln.startswith("="):
            crc_line = ln[1:]
        else:
            body_lines.append(ln)
    try:
        data = base64.b64decode("".join(body_lines), validate=True)
    except Exception as e:
        raise ArmorError(f"bad armor body: {e}")
    if crc_line is not None:
        try:
            want = int.from_bytes(base64.b64decode(crc_line,
                                                   validate=True), "big")
        except Exception as e:
            raise ArmorError(f"bad armor CRC trailer: {e}")
        if _crc24(data) != want:
            raise ArmorError("armor CRC mismatch")
    return block_type, headers, data


def armor_priv_key(key_bytes: bytes, key_type: str) -> str:
    """Keyfile armor (the reference pairs this with bcrypt+xsalsa20
    encryption in the keyring; plaintext armor is the crypto/armor layer)."""
    return encode_armor("TENDERMINT PRIVATE KEY",
                        {"type": key_type, "kdf": "none"}, key_bytes)


def unarmor_priv_key(text: str) -> tuple[bytes, str]:
    block_type, headers, data = decode_armor(text)
    if block_type != "TENDERMINT PRIVATE KEY":
        raise ArmorError(f"unexpected block type {block_type!r}")
    return data, headers.get("type", "")
