"""Content-addressed chunk manifests for the snapshot fabric
(counterpart of ``cometbft_tpu/statesync/manifest.py``).

The reference statesync protocol detects a corrupt chunk only when the
APP rejects it — for the kvstore (and most real apps) that is a
whole-snapshot hash check at the END of the restore, so one flipped
byte costs every chunk already applied (``APPLY_CHUNK_RETRY`` →
full reset).  A manifest moves integrity to the wire layer: the per-
chunk sha256 list, bound to the snapshot hash through a single root
digest, lets the fetcher verify every chunk BEFORE it is spooled and
re-request only the bad one from another holder.

Binding: ``root = sha256(DOMAIN || snapshot_hash || h_0 || h_1 ...)``.
The snapshot hash in the preimage means a manifest cannot be replayed
across snapshots; the domain tag keeps the digest from colliding with
any other sha256 use in the tree.  Offers (``sres``) advertise the
root; the hash list itself travels on demand (``mreq``/``mres``) so
the offer stays O(1) regardless of snapshot size.

The root is only as trustworthy as the peers advertising it — the
syncer takes the root advertised by the LARGEST set of offering peers
(deterministic tie-break on the digest), so a lone byzantine seed
lying about the root merely excludes itself from manifest service
while its chunks are still checked against the honest manifest.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

_DOMAIN = b"cmt-statesync-manifest/v1"
HASH_LEN = 32


def hash_chunk(data: bytes) -> bytes:
    """The per-chunk digest every fetched chunk is checked against."""
    return hashlib.sha256(data).digest()


def manifest_root(snapshot_hash: bytes, chunk_hashes) -> bytes:
    """Root digest binding an ordered chunk-hash list to a snapshot."""
    h = hashlib.sha256()
    h.update(_DOMAIN)
    h.update(bytes(snapshot_hash))
    for ch in chunk_hashes:
        h.update(bytes(ch))
    return h.digest()


def valid_hash_list(snapshot_hash: bytes, hashes, n_chunks: int,
                    expected_root: bytes) -> bool:
    """Full wire-side validation of a received ``mres`` hash list: the
    right shape (one 32-byte digest per chunk) AND the right binding
    (recomputed root matches the offer-advertised one)."""
    if not isinstance(hashes, (list, tuple)) or len(hashes) != n_chunks:
        return False
    for ch in hashes:
        if not isinstance(ch, (bytes, bytearray)) or len(ch) != HASH_LEN:
            return False
    return manifest_root(snapshot_hash, hashes) == expected_root


@dataclass(frozen=True)
class ChunkManifest:
    """An immutable verified manifest (serving-side cache value)."""

    snapshot_hash: bytes
    hashes: tuple = field(default_factory=tuple)   # per-chunk sha256

    @classmethod
    def from_chunks(cls, snapshot_hash: bytes, chunks) -> "ChunkManifest":
        return cls(snapshot_hash=bytes(snapshot_hash),
                   hashes=tuple(hash_chunk(c) for c in chunks))

    @property
    def root(self) -> bytes:
        return manifest_root(self.snapshot_hash, self.hashes)

    def __len__(self) -> int:
        return len(self.hashes)

    def verify_chunk(self, index: int, data: bytes) -> bool:
        if not 0 <= index < len(self.hashes):
            return False
        return hash_chunk(data) == self.hashes[index]
