"""Evidence reactor: gossip pending evidence to peers on channel 0x38
(counterpart of ``cometbft_tpu/evidence/reactor.py``; reference:
``internal/evidence/reactor.go``, channel id at :17).  Messages are the
JAX package's bytes (``types/_msgpack.py``).

The reference walks the pool's clist per peer, sending one evidence at a
time; with the pool's on_evidence_added hook and small evidence volumes,
broadcasting on add + a full sync on peer connect covers the same
delivery guarantees."""

from __future__ import annotations

from ..libs import aio
from ..types import _msgpack, codec
from ..types.evidence import EvidenceError, EvidenceNotApplicableError
from ..p2p.reactor import ChannelDescriptor, Reactor
from .pool import EvidencePool

EVIDENCE_CHANNEL = 0x38
PENDING_SYNC_MAX_BYTES = 1 << 20


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool):
        super().__init__()
        self.pool = pool
        pool.on_evidence_added = self._broadcast_evidence

    def get_channels(self):
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=6,
                                  send_queue_capacity=100, name="evidence")]

    def add_peer(self, peer) -> None:
        for ev in self.pool.pending_evidence(PENDING_SYNC_MAX_BYTES):
            peer.send(EVIDENCE_CHANNEL, self._msg(ev))

    def receive(self, channel_id: int, peer, msg: bytes) -> None:
        d = _msgpack.unpackb(msg)
        if d.get("@") != "ev":
            return
        try:
            self.pool.add_evidence(codec.unpack(d["e"]))
        except EvidenceNotApplicableError:
            # evidence we can't currently judge (expired, below our
            # block base, no state yet): drop it WITHOUT punishing — a
            # freshly statesync'd node must not ban honest peers
            # re-gossiping legitimate pending evidence
            return
        except EvidenceError as e:
            # invalid gossiped evidence: drop the peer (reactor.go Receive
            # punishes the sender) and score it heavily — fabricated
            # evidence is a deliberate act, repetition earns a timed ban
            if self.switch is None:
                return
            if hasattr(self.switch, "report_peer"):
                self.switch.report_peer(peer.id, "bad_evidence",
                                        detail=repr(e)[:120],
                                        disconnect=True)
            else:
                aio.spawn(self.switch.stop_peer_for_error(
                    peer, "invalid evidence"))

    def _msg(self, ev) -> bytes:
        return _msgpack.packb({"@": "ev", "e": codec.pack(ev)})

    def _broadcast_evidence(self, ev) -> None:
        if self.switch is not None:
            self.switch.broadcast(EVIDENCE_CHANNEL, self._msg(ev))
