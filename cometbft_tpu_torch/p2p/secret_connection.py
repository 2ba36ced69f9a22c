"""Authenticated-encryption connection upgrade (counterpart of
``cometbft_tpu/p2p/secret_connection.py``; reference:
``p2p/conn/secret_connection.go:33-80``, the STS protocol).

X25519 ephemeral ECDH, an HKDF-SHA256 transcript, two ChaCha20-Poly1305
AEADs (one a direction) over fixed-size frames, and an Ed25519 challenge
signature that authenticates the persistent node key.  The bytes on the
wire are the JAX package's, so a port node and a JAX node connect.

- X25519 and the AEAD come from ``crypto/_sc_fallback.py`` (the frames
  through the native library, ``csrc/host/aead.cpp``).
- The challenge is signed by the native signer (``Ed25519PrivKey.sign``).
- The peer's challenge signature is checked on ``device``: a one-lane
  ``BatchVerifier`` call queued on the device-owner thread
  (``crypto/batch.py:device_await``) and awaited, so the event loop
  runs on while the device works.  Nothing verifies on the host.

Frame layout: every sealed frame carries exactly ``DATA_LEN`` plaintext
bytes of which the first two are the LE payload length (0..DATA_LEN-2);
nonces are 12-byte little-endian send counters, never reused because each
direction has its own key and counter.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import struct

from ..crypto import batch as _batch
from ..crypto._sc_fallback import (ChaCha20Poly1305, InvalidTag,
                                   X25519PrivateKey, X25519PublicKey)
from ..crypto.keys import Ed25519PrivKey, Ed25519PubKey

__all__ = ["DATA_LEN", "DATA_MAX", "FRAME_LEN", "SecretConnectionError",
           "SecretConnection", "handshake", "HANDSHAKE_CHECKS"]

DATA_LEN = 1024                     # plaintext bytes per frame (incl. 2-len)
DATA_MAX = DATA_LEN - 2
FRAME_LEN = DATA_LEN + 16           # + poly1305 tag
HKDF_INFO = b"TPU_BFT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"


class SecretConnectionError(Exception):
    pass


def _hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int) -> bytes:
    prk = hashlib.sha256(salt + ikm).digest()
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = hashlib.sha256(prk + t + info + bytes([i])).digest()
        out += t
        i += 1
    return out[:length]


class SecretConnection:
    """Byte-stream over AEAD frames.  Use :meth:`handshake` to construct."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 send_aead: ChaCha20Poly1305, recv_aead: ChaCha20Poly1305,
                 remote_pub_key: Ed25519PubKey):
        self._reader = reader
        self._writer = writer
        self._send = send_aead
        self._recv = recv_aead
        self._send_nonce = 0
        self._recv_nonce = 0
        self._buf = bytearray()
        self.remote_pub_key = remote_pub_key

    @property
    def remote_addr(self) -> str:
        """The socket's remote ``host:port``: the only address an inbound
        peer has proven (its advertised listen address is hearsay, and
        pex attributes addresses to this one)."""
        try:
            peername = self._writer.get_extra_info("peername")
            if peername:
                return f"{peername[0]}:{peername[1]}"
        except Exception:
            pass
        return ""

    # -------------------------------------------------------------- frames

    def _nonce(self, counter: int) -> bytes:
        return struct.pack("<Q", counter) + b"\x00\x00\x00\x00"

    async def _write_frame(self, payload: bytes) -> None:
        if len(payload) > DATA_MAX:
            raise SecretConnectionError("frame payload over DATA_MAX")
        frame = struct.pack("<H", len(payload)) + payload
        frame += b"\x00" * (DATA_LEN - len(frame))
        sealed = self._send.encrypt(self._nonce(self._send_nonce), frame,
                                    None)
        self._send_nonce += 1
        self._writer.write(sealed)

    async def _read_frame(self) -> bytes:
        sealed = await self._reader.readexactly(FRAME_LEN)
        try:
            frame = self._recv.decrypt(self._nonce(self._recv_nonce),
                                       sealed, None)
        except InvalidTag as e:
            raise SecretConnectionError(f"frame decryption failed: {e}")
        self._recv_nonce += 1
        (n,) = struct.unpack_from("<H", frame)
        if n > DATA_MAX:
            raise SecretConnectionError("corrupt frame length")
        return frame[2:2 + n]

    # -------------------------------------------------------- byte stream

    async def write(self, data: bytes) -> None:
        for off in range(0, len(data), DATA_MAX):
            await self._write_frame(data[off:off + DATA_MAX])
        await self._writer.drain()

    async def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf.extend(await self._read_frame())
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    # ------------------------------------------------------- msg framing

    async def write_msg(self, msg: bytes) -> None:
        await self.write(struct.pack("<I", len(msg)) + msg)

    async def read_msg(self, max_size: int = 1 << 22) -> bytes:
        (n,) = struct.unpack("<I", await self.read(4))
        if n > max_size:
            raise SecretConnectionError(f"message too large: {n}")
        return await self.read(n)

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass


# challenge-signature checks made on a device, by device name
HANDSHAKE_CHECKS: collections.Counter = collections.Counter()


async def verify_challenge(pub: Ed25519PubKey, challenge: bytes, sig: bytes,
                           device) -> bool:
    """The peer's challenge signature, checked in one lane on ``device``
    on the device-owner thread; the caller's loop waits without
    blocking."""

    def run() -> bool:
        bv = _batch.create_batch_verifier(device)
        bv.add(pub, challenge, sig)
        return bool(bv.verify()[1][0])

    HANDSHAKE_CHECKS[str(device)] += 1
    return await _batch.device_await(run)


async def handshake(reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter,
                    priv_key: Ed25519PrivKey,
                    device=None) -> SecretConnection:
    """Upgrade a raw TCP stream (secret_connection.go MakeSecretConnection).

    1. swap ephemeral X25519 pubkeys (the only plaintext on the wire);
    2. HKDF(shared, salt=sorted eph pubs) -> two keys + challenge;
       low-sorted eph pub gets key A for sending, high gets key B —
       role assignment needs no dialer/listener flag;
    3. inside the encrypted channel, swap (node pubkey, sig(challenge))
       and verify it on ``device`` — authenticates the persistent
       identity (STS).
    """
    eph_priv = X25519PrivateKey.generate()
    eph_pub = eph_priv.public_key().public_bytes_raw()
    writer.write(eph_pub)
    await writer.drain()
    their_eph_pub = await reader.readexactly(32)
    if their_eph_pub == eph_pub:
        raise SecretConnectionError("identical ephemeral keys (reflection?)")
    shared = eph_priv.exchange(
        X25519PublicKey.from_public_bytes(their_eph_pub))

    lo, hi = sorted((eph_pub, their_eph_pub))
    okm = _hkdf_sha256(shared, salt=lo + hi, info=HKDF_INFO, length=96)
    key_a, key_b, challenge = okm[:32], okm[32:64], okm[64:]
    if eph_pub == lo:
        send_key, recv_key = key_a, key_b
    else:
        send_key, recv_key = key_b, key_a

    conn = SecretConnection(reader, writer,
                            ChaCha20Poly1305(send_key),
                            ChaCha20Poly1305(recv_key),
                            remote_pub_key=None)

    sig = priv_key.sign(challenge)
    await conn.write_msg(priv_key.pub_key().bytes() + sig)
    auth = await conn.read_msg(max_size=96)
    if len(auth) != 96:
        raise SecretConnectionError("bad auth message size")
    remote_pub, remote_sig = Ed25519PubKey(auth[:32]), auth[32:]
    if not await verify_challenge(remote_pub, challenge, remote_sig,
                                  device):
        raise SecretConnectionError("challenge signature verification failed")
    conn.remote_pub_key = remote_pub
    return conn
