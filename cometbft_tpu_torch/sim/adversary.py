"""Seeded byzantine adversaries (counterpart of
``cometbft_tpu/sim/adversary.py``).

Each adversary is attached to a :class:`~cometbft_tpu_torch.sim.node.SimNode`
that otherwise runs the honest stack: the attack wraps its outbound hooks
or adds a broadcast task, so everything it emits travels the real wire
(MConnection packets, fault sites, peer scoring) and everything honest
nodes do about it is their real response.  Frames are packed with the
port's MessagePack subset (``types/_msgpack.py``), the same bytes as
``msgpack.packb(..., use_bin_type=True)``.

Kinds (``KINDS``):

- ``equivocator`` — the double-signer: every non-nil vote it casts is
  followed by a second, validly-signed vote for a fabricated block at
  the same height/round/type.  Honest vote sets raise
  ``ConflictingVoteError`` -> ``on_conflicting_vote`` -> evidence pool
  -> ``DuplicateVoteEvidence`` in a committed block.  (With one
  equivocator among 3f+1 honest validators safety holds; the run must
  end fork-free WITH evidence committed.)
- ``amnesiac`` — the forgetful voter: a seeded fraction of its own vote
  broadcasts are silently withheld (it voted, gossip never hears).
  Nothing provable ever hits the wire — pure liveness pressure, the
  taxonomy's not-slashable quadrant.
- ``spammer`` — invalid-part/proposal spammer: periodically broadcasts
  block parts with garbage payloads and fake merkle proofs targeted at
  the net's current height/round (plus the occasional non-msgpack
  frame).  Honest handlers raise ``PartSetError`` ->
  ``invalid_part``/``protocol_error`` scoring -> disconnect, then a
  timed ban as it keeps coming.
- ``flooder`` — the flood-then-ban-cycle adversary: pumps junk
  transactions at every peer on the mempool channel, alternating both
  gossip dialects — full-body pushes (old protocol) AND
  content-addressed announce storms, where it announces junk tx hashes
  and serves the junk bodies when honest peers fetch them.  Each junk
  tx scores ``invalid_tx`` (feather-weight — the ban takes sustained
  abuse), the ban's TTL expires, it reconnects and floods again.

All randomness is drawn from a per-adversary ``random.Random`` seeded
from ``(scenario seed, node name)``, so the attack schedule replays
bit-identically.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import replace

from ..consensus.reactor import DATA_CHANNEL
from ..crypto.merkle import Proof
from ..libs import aio, clock
from ..mempool.reactor import MEMPOOL_CHANNEL
from ..types._msgpack import packb, unpackb
from ..types.block_id import BlockID, PartSetHeader
from .node import SimNode

__all__ = ["KINDS", "attach"]

KINDS = ("equivocator", "amnesiac", "spammer", "flooder")


def attach(node: SimNode, kind: str, seed: int) -> None:
    """Turn ``node`` byzantine.  Call after construction, before
    ``start()``."""
    if kind not in KINDS:
        raise ValueError(f"unknown adversary kind {kind!r}; "
                         f"expected one of {KINDS}")
    node.byzantine = kind
    rng = random.Random(f"{seed}:adversary:{node.name}")
    if kind == "equivocator":
        _attach_equivocator(node, rng)
    elif kind == "amnesiac":
        _attach_amnesiac(node, rng)
    elif kind == "spammer":
        node._adv_tasks.append(aio.spawn(_spam_parts(node, rng)))
    elif kind == "flooder":
        node._adv_tasks.append(aio.spawn(_flood_txs(node, rng)))


# ----------------------------------------------------------- vote attacks

def _attach_equivocator(node: SimNode, rng: random.Random) -> None:
    cs = node.consensus
    orig = cs.broadcast_vote
    priv = node.pv.priv_key

    def equivocate(vote) -> None:
        orig(vote)
        try:
            if vote.block_id.is_nil() or not vote.signature:
                return
            alt = BlockID(rng.randbytes(32),
                          PartSetHeader(1, rng.randbytes(32)))
            dup = replace(vote, block_id=alt, signature=b"",
                          extension=b"", extension_signature=b"",
                          _sb_memo=None)
            dup.signature = priv.sign(dup.sign_bytes_for(
                cs.state.chain_id, priv.type()))
            orig(dup)
        except Exception:
            pass                    # an attack must never crash its host

    cs.broadcast_vote = equivocate


def _attach_amnesiac(node: SimNode, rng: random.Random,
                     forget_prob: float = 0.35) -> None:
    cs = node.consensus
    orig = cs.broadcast_vote

    def forgetful(vote) -> None:
        if rng.random() < forget_prob:
            return                  # voted, told no one
        orig(vote)

    cs.broadcast_vote = forgetful


# --------------------------------------------------------- wire spammers

async def _spam_parts(node: SimNode, rng: random.Random,
                      interval_s: float = 0.25) -> None:
    """Invalid block parts (bad merkle proofs) aimed at the live
    height/round, with the odd undecodable frame mixed in."""
    cs = node.consensus
    sw = node.switch
    try:
        while True:
            await clock.sleep(interval_s)
            if not sw.peers:
                continue
            if rng.random() < 0.2:
                sw.broadcast(DATA_CHANNEL, rng.randbytes(48))
                continue
            proof = Proof(total=4, index=rng.randrange(4),
                          leaf_hash=rng.randbytes(32),
                          aunts=(rng.randbytes(32), rng.randbytes(32)))
            part = {"i": proof.index, "b": rng.randbytes(64),
                    "pt": proof.total, "pi": proof.index,
                    "pl": proof.leaf_hash, "pa": list(proof.aunts)}
            msg = packb({"@": "part", "h": cs.rs.height,
                         "r": cs.rs.round, "p": part})
            sw.broadcast(DATA_CHANNEL, msg)
    except asyncio.CancelledError:
        raise
    except Exception:
        pass


async def _flood_txs(node: SimNode, rng: random.Random,
                     interval_s: float = 0.1, burst: int = 12,
                     stash_bound: int = 4096) -> None:
    """Junk-tx gossip over BOTH dialects: app-rejected txs score
    invalid_tx on every receiving peer until the ban threshold trips;
    after the TTL the flooder's reconnects are admitted again and the
    cycle repeats.

    Half the bursts are full-body pushes (the old protocol); the other
    half are content-addressed announce storms — junk hashes announced
    with a ``hi`` capability greeting, the junk bodies stashed and
    served when an honest peer fetches them, so the victim pays the
    announce+fetch round trip AND the CheckTx rejection.  The stash is
    the flooder's only state; honest scoring is identical either way."""
    from ..mempool.mempool import TxKey

    sw = node.switch
    stash: dict[bytes, bytes] = {}
    reactor = node.mempool_reactor or sw.reactors.get("mempool")
    if reactor is not None:
        orig_receive = reactor.receive

        def serve_junk(channel_id, peer, msg):
            """Answer fetch requests from the junk stash (a real node
            serves from its pool — the junk never got in), then let the
            honest reactor see the frame too."""
            try:
                d = unpackb(msg)
                req = d.get("req") if isinstance(d, dict) else None
                if req:
                    bodies = [stash[h] for h in req if h in stash]
                    if bodies:
                        peer.send(MEMPOOL_CHANNEL, packb({"txs": bodies}))
            except Exception:
                pass
            return orig_receive(channel_id, peer, msg)

        reactor.receive = serve_junk
    try:
        while True:
            await clock.sleep(interval_s)
            if not sw.peers:
                continue
            # mostly hex payloads: no '=', so the kvstore app rejects
            # them (invalid_tx scoring).  A seeded minority carry '='
            # and ARE valid — classic volumetric spam that fills small
            # pools, so honest nodes exercise the full-pool shed path
            # (drop pre-CheckTx) on the rest of the storm.
            txs = [(b"fl" + rng.randbytes(8).hex().encode() + b"=1")
                   if rng.random() < 0.3 else
                   (b"\x00flood:" + rng.randbytes(12).hex().encode())
                   for _ in range(burst)]
            if rng.random() < 0.5:
                keys = [TxKey(t) for t in txs]
                for k, t in zip(keys, txs):
                    stash[k] = t
                while len(stash) > stash_bound:
                    del stash[next(iter(stash))]
                sw.broadcast(MEMPOOL_CHANNEL, packb({"hi": 1, "ann": keys}))
            else:
                sw.broadcast(MEMPOOL_CHANNEL, packb({"txs": txs}))
    except asyncio.CancelledError:
        raise
    except Exception:
        pass
