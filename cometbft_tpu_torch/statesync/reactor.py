"""Statesync reactor: snapshot/chunk/manifest exchange over p2p
(counterpart of ``cometbft_tpu/statesync/reactor.py``; reference:
``statesync/reactor.go:66,109,266``; channels 0x60/0x61 from
``statesync/reactor.go:23-25``).

Serving side answers from the local app's snapshot connection, through
a byte-budgeted chunk LRU behind an admission gate (``cache.py``) —
concurrent bootstrappers hit RAM, overload sheds instead of stalling
the event loop.  Snapshot offers additionally advertise the manifest
root (``mr``) binding per-chunk sha256 hashes to the snapshot hash;
fetchers pull the hash list itself with ``mreq``/``mres`` and verify
every chunk before spooling (``manifest.py``).  The syncing side
accumulates offers/manifests/chunks into the Syncer.  Messages are
packed with the port's MessagePack subset (``types/_msgpack.py``), byte
for byte the JAX package's."""

from __future__ import annotations

from ..abci.types import Snapshot
from ..libs import aio, failures
from ..libs import log as tmlog
from ..p2p.reactor import ChannelDescriptor, Reactor
from ..types import _msgpack
from .cache import AdmissionGate, ChunkLRU, _serve_metrics
from .manifest import ChunkManifest, hash_chunk

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

# Serving-side defaults (config: [statesync] chunk_cache_bytes /
# serve_concurrency / serve_queue)
CHUNK_CACHE_BYTES = 64 * 1024 * 1024
SERVE_CONCURRENCY = 8
SERVE_QUEUE = 64
# Manifests are tiny (32 B / chunk) but computing one walks the whole
# snapshot; keep the last few snapshots' worth
_MANIFEST_CACHE_SIZE = 16


def _pack(tag: str, **fields) -> bytes:
    fields["@"] = tag
    return _msgpack.packb(fields)


class StatesyncReactor(Reactor):
    def __init__(self, app_conns, syncer=None, name: str = "ss", *,
                 chunk_cache_bytes: int = CHUNK_CACHE_BYTES,
                 serve_concurrency: int = SERVE_CONCURRENCY,
                 serve_queue: int = SERVE_QUEUE):
        super().__init__()
        self.app_conns = app_conns
        self.syncer = syncer          # set when this node is syncing
        self.name = name
        self.log = tmlog.logger("statesync.reactor", node=name)
        self._cache = ChunkLRU(max_size=4096, max_bytes=chunk_cache_bytes)
        self._gate = AdmissionGate(concurrency=serve_concurrency,
                                   max_queued=serve_queue)
        self._manifests: dict[tuple, ChunkManifest] = {}
        self._m = _serve_metrics()

    def get_channels(self):
        return [
            ChannelDescriptor(SNAPSHOT_CHANNEL, priority=5,
                              send_queue_capacity=10, name="snapshot"),
            ChannelDescriptor(CHUNK_CHANNEL, priority=3,
                              send_queue_capacity=20, name="chunk"),
        ]

    def add_peer(self, peer) -> None:
        if self.syncer is not None:
            peer.send(SNAPSHOT_CHANNEL, _pack("sreq"))

    def remove_peer(self, peer, reason=None) -> None:
        if self.syncer is not None:
            self.syncer.remove_peer(peer.id)

    def receive(self, channel_id: int, peer, msg: bytes) -> None:
        d = _msgpack.unpackb(msg)
        tag = d.get("@")
        if channel_id == SNAPSHOT_CHANNEL:
            if tag == "sreq":
                if self._gate.try_queue():
                    aio.spawn(self._serve_snapshots(peer))
                else:
                    self._m.shed.inc(node=self.name)
            elif tag == "sres" and self.syncer is not None:
                self.syncer.add_snapshot(peer.id, Snapshot(
                    height=d["h"], format=d["f"], chunks=d["c"],
                    hash=d["hash"], metadata=d.get("m", b"")),
                    manifest_root=d.get("mr"))
            elif tag == "mreq":
                if self._gate.try_queue():
                    aio.spawn(self._serve_manifest(peer, d))
                else:
                    self._m.shed.inc(node=self.name)
            elif tag == "mres" and self.syncer is not None:
                self.syncer.add_manifest(
                    peer.id, d["h"], d["f"], d.get("sh", b""),
                    list(d.get("hs", [])))
        elif channel_id == CHUNK_CHANNEL:
            if tag == "creq":
                if self._gate.try_queue():
                    aio.spawn(self._serve_chunk(peer, d))
                else:
                    self._m.shed.inc(node=self.name)
            elif tag == "cres" and self.syncer is not None:
                self.syncer.add_chunk(peer.id, d["h"], d["f"], d["i"],
                                      d["chunk"], d.get("sh", b""))

    # -------------------------------------------------------- serving

    async def _load_chunk(self, height: int, format_: int,
                          index: int) -> bytes | None:
        """Cache-through chunk load: the LRU key is (height, format,
        index) — content-addressing happens fetcher-side; here identity
        is cheap and correct because a snapshot is immutable."""
        key = (height, format_, index)
        cached = self._cache.get(key)
        if cached is not None:
            self._m.cache_hits.inc(node=self.name)
            return cached
        self._m.cache_misses.inc(node=self.name)
        chunk = await self.app_conns.snapshot.load_snapshot_chunk(
            height, format_, index)
        if isinstance(chunk, (bytes, bytearray)):
            chunk = bytes(chunk)
            self._cache.put(key, chunk)
        return chunk

    async def _manifest_for(self, snapshot) -> ChunkManifest:
        """Build (and cache) the chunk manifest for a local snapshot by
        hashing every chunk — also warms the chunk LRU, so the offer
        that advertises the root pre-pays the fetches that follow it."""
        key = (snapshot.height, snapshot.format, snapshot.hash)
        mf = self._manifests.get(key)
        if mf is not None:
            return mf
        hashes = []
        for i in range(snapshot.chunks):
            chunk = await self._load_chunk(snapshot.height,
                                           snapshot.format, i)
            if not isinstance(chunk, (bytes, bytearray)):
                raise ValueError(f"chunk {i} unavailable")
            hashes.append(hash_chunk(bytes(chunk)))
        mf = ChunkManifest(snapshot_hash=bytes(snapshot.hash),
                           hashes=tuple(hashes))
        while len(self._manifests) >= _MANIFEST_CACHE_SIZE:
            self._manifests.pop(next(iter(self._manifests)))
        self._manifests[key] = mf
        return mf

    async def _serve_snapshots(self, peer) -> None:
        """reactor.go Receive(SnapshotRequest) -> recentSnapshots, plus
        the manifest root per offer (omitted, not failed, if the chunks
        cannot be walked — the offer still works for legacy fetchers)."""
        async with self._gate:
            try:
                snaps = await self.app_conns.snapshot.list_snapshots()
            except Exception:
                return
            for s in snaps[-10:]:
                fields = dict(h=s.height, f=s.format, c=s.chunks,
                              hash=s.hash, m=s.metadata)
                try:
                    mf = await self._manifest_for(s)
                    fields["mr"] = mf.root
                except Exception:
                    self.log.warn("cannot build manifest for offer",
                                  height=s.height)
                peer.send(SNAPSHOT_CHANNEL, _pack("sres", **fields))

    async def _serve_manifest(self, peer, d) -> None:
        async with self._gate:
            key = (d["h"], d["f"], d.get("sh", b""))
            mf = self._manifests.get(key)
            if mf is None:
                # not cached (e.g. restarted since the offer): rebuild
                # from the app's snapshot list
                try:
                    snaps = await self.app_conns.snapshot.list_snapshots()
                    snap = next(s for s in snaps
                                if (s.height, s.format, s.hash) == key)
                    mf = await self._manifest_for(snap)
                except Exception:
                    return
            self._m.manifests_served.inc(node=self.name)
            peer.send(SNAPSHOT_CHANNEL, _pack(
                "mres", h=d["h"], f=d["f"], sh=d.get("sh", b""),
                hs=list(mf.hashes)))

    async def _serve_chunk(self, peer, d) -> None:
        async with self._gate:
            try:
                chunk = await self._load_chunk(d["h"], d["f"], d["i"])
            except Exception:
                return
            if chunk is None:
                return
            # chaos site: a byzantine/corrupting seed flips one bit in
            # the served chunk AFTER the cache (the cache keeps honest
            # bytes; every serve re-corrupts deterministically)
            f = failures.fire("statesync.serve.corrupt", node=self.name,
                              chan="chunk")
            if f is not None and len(chunk):
                data = bytearray(chunk)
                rng = failures.site_rng("statesync.serve.corrupt")
                data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
                chunk = bytes(data)
            self._m.chunks_served.inc(node=self.name)
            peer.send(CHUNK_CHANNEL, _pack(
                "cres", h=d["h"], f=d["f"], i=d["i"], chunk=chunk,
                sh=d.get("sh", b"")))

    # ------------------------------------------------------- fetching

    def request_chunk(self, peer_id: str, height: int, format_: int,
                      index: int, snapshot_hash: bytes = b"") -> bool:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is None:
            return False
        return peer.send(CHUNK_CHANNEL, _pack(
            "creq", h=height, f=format_, i=index, sh=snapshot_hash))

    def request_manifest(self, peer_id: str, height: int, format_: int,
                         snapshot_hash: bytes = b"") -> bool:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is None:
            return False
        return peer.send(SNAPSHOT_CHANNEL, _pack(
            "mreq", h=height, f=format_, sh=snapshot_hash))

    def broadcast_snapshot_request(self) -> None:
        if self.switch is not None:
            self.switch.broadcast(SNAPSHOT_CHANNEL, _pack("sreq"))
