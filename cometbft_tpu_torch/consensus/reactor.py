"""Consensus reactor: gossips proposals, block parts and votes over the
p2p switch (counterpart of ``cometbft_tpu/consensus/reactor.py``;
reference: ``internal/consensus/reactor.go:41,590,646,708`` and
``PeerState`` at ``:1079``).  Messages are packed with the port's
MessagePack subset (``types/_msgpack.py``) into the JAX package's bytes,
so port and JAX nodes gossip to each other.

Four channels, same ids as the reference (``reactor.go:27-30``):
STATE (0x20) round-step/has-vote/maj23 announcements, DATA (0x21)
proposals + block parts, VOTE (0x22) votes, VOTE_SET_BITS (0x23) vote-set
bit-array replies.  Per-peer gossip tasks mirror gossipDataRoutine /
gossipVotesRoutine / queryMaj23Routine; all state access happens on the one
event loop, so PeerState needs no locks (single-writer discipline).
"""

from __future__ import annotations

import asyncio
import functools
import random

from ..libs import clock
from ..libs.bits import BitArray
from ..types import _msgpack, codec
from ..types.block_id import BlockID
from ..types.commit import Commit
from ..types.part_set import Part
from ..types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Vote
from ..p2p.reactor import ChannelDescriptor, Reactor
from .round_state import STEP_NEW_HEIGHT, STEP_PRECOMMIT, STEP_PREVOTE
from .state import ConsensusState

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

GOSSIP_SLEEP = 0.01                 # config PeerGossipSleepDuration analog
QUERY_MAJ23_SLEEP = 2.0


@functools.cache
def _dup_votes_metric():
    from ..libs import metrics as _m
    from ..p2p.metrics import PEER_LABEL_BUDGET

    # per-peer children (Counter.bind at add_peer); the cardinality
    # guard caps them at the peer-label budget under churn
    return _m.counter(
        "consensus_gossip_duplicate_votes_total",
        "re-gossiped votes dropped at the reactor (already in a vote "
        "set), by sending peer",
        max_label_sets=PEER_LABEL_BUDGET)


@functools.cache
def _useful_votes_metric():
    from ..libs import metrics as _m
    from ..p2p.metrics import PEER_LABEL_BUDGET

    return _m.counter(
        "consensus_gossip_useful_votes_total",
        "gossiped votes accepted into processing (not already held), by "
        "sending peer — useful/(useful+duplicate) is that peer's gossip "
        "efficiency",
        max_label_sets=PEER_LABEL_BUDGET)


@functools.cache
def _msg_type_metric():
    from ..libs import metrics as _m

    return _m.counter(
        "consensus_reactor_msgs_total",
        "consensus reactor messages received, by wire tag (nrs, hv, nvb, "
        "maj23, prop, pol, part, vote, vsb)")


# ------------------------------------------------------------- wire helpers

def _ba_to_wire(ba: BitArray | None):
    if ba is None:
        return None
    return {"n": ba.size, "b": ba._bits.to_bytes((ba.size + 7) // 8 or 1,
                                                 "little")}


def _ba_from_wire(d) -> BitArray | None:
    if d is None:
        return None
    return BitArray(d["n"], int.from_bytes(d["b"], "little"))


def _pack(tag: str, **fields) -> bytes:
    fields["@"] = tag
    return _msgpack.packb(fields)


def _unpack(raw: bytes) -> dict:
    return _msgpack.unpackb(raw)


def votes_from_commit(commit: Commit) -> list[Vote]:
    """Reconstruct precommit Votes from a stored commit so lagging peers
    can be caught up vote-by-vote (reactor.go:646 gossip for earlier
    heights; Commit.ToVoteSet types/block.go:1134).

    AGGREGATE lanes are skipped: their individual signatures were folded
    into ``commit.agg_signature`` and no longer exist — a reconstructed
    empty-signature vote would only earn the sender a misbehavior report
    at the receiver.  Aggregated commits catch peers up whole
    (:meth:`ConsensusReactor._send_catchup_commit`)."""
    out = []
    for i, cs in enumerate(commit.signatures):
        if cs.is_absent() or cs.is_aggregate():
            continue
        out.append(Vote(
            type=PRECOMMIT_TYPE, height=commit.height, round=commit.round,
            block_id=commit.block_id if cs.is_commit() else BlockID(),
            timestamp_ns=cs.timestamp_ns, validator_address=cs.validator_address,
            validator_index=i, signature=cs.signature))
    return out


# ----------------------------------------------------------------- PeerState

class PeerState:
    """What we know about one peer's consensus view (reactor.go:1079)."""

    def __init__(self, rng: random.Random | None = None):
        # per-peer seeded RNG for gossip picks/jitter (DET001): drawing
        # from the GLOBAL rng makes the sequence a function of coroutine
        # interleaving across every peer and node in the process, which
        # breaks the scenario lab's replay-identity contract.  Keyed per
        # (node, peer) the sequence is a pure function of identity —
        # decorrelated between peers, byte-stable across replays.
        self.rng = rng if rng is not None else random.Random()
        self.height = 0
        self.round = -1
        self.step = 0
        self.proposal = False
        self.proposal_block_parts_header = None
        self.proposal_block_parts: BitArray | None = None
        self.proposal_pol_round = -1
        self.proposal_pol: BitArray | None = None
        self.prevotes: dict[int, BitArray] = {}
        self.precommits: dict[int, BitArray] = {}
        self.last_commit_round = -1
        self.last_commit: BitArray | None = None
        # height of the last whole catch-up commit shipped to this peer
        # (aggregate catch-up; see _send_catchup_commit)
        self.commit_sent_height = 0

    def apply_new_round_step(self, h: int, r: int, step: int,
                             last_commit_round: int) -> None:
        prev_h, prev_r = self.height, self.round
        self.height, self.round, self.step = h, r, step
        if prev_h != h or prev_r != r:
            self.proposal = False
            self.proposal_block_parts_header = None
            self.proposal_block_parts = None
            self.proposal_pol_round = -1
            self.proposal_pol = None
        if prev_h != h:
            if prev_h + 1 == h and prev_r != -1:
                # peer's round precommits became its last commit
                self.last_commit = self.precommits.get(prev_r)
                self.last_commit_round = prev_r
            else:
                self.last_commit = None
                self.last_commit_round = last_commit_round
            self.prevotes.clear()
            self.precommits.clear()

    def vote_bits(self, height: int, round_: int, typ: int,
                  n_validators: int) -> BitArray | None:
        if height == self.height:
            table = self.prevotes if typ == PREVOTE_TYPE else self.precommits
            if round_ not in table:
                table[round_] = BitArray(n_validators)
            return table[round_]
        if height == self.height - 1 and typ == PRECOMMIT_TYPE and \
                round_ == self.last_commit_round:
            if self.last_commit is None:
                self.last_commit = BitArray(n_validators)
            return self.last_commit
        return None

    def set_has_vote(self, height: int, round_: int, typ: int, index: int,
                     n_validators: int) -> None:
        ba = self.vote_bits(height, round_, typ, n_validators)
        if ba is not None:
            ba.set_index(index, True)

    def apply_vote_set_bits(self, height: int, round_: int, typ: int,
                            bits: BitArray) -> None:
        ours = self.vote_bits(height, round_, typ, bits.size)
        if ours is not None:
            merged = ours.or_(bits)
            if typ == PREVOTE_TYPE and height == self.height:
                self.prevotes[round_] = merged
            elif typ == PRECOMMIT_TYPE and height == self.height:
                self.precommits[round_] = merged
            else:
                self.last_commit = merged


# ------------------------------------------------------------------ reactor

_KNOWN_TAGS = ("nrs", "hv", "nvb", "maj23", "prop", "pol", "part",
               "vote", "vsb", "commit")


class ConsensusReactor(Reactor):
    def __init__(self, cs: ConsensusState,
                 gossip_sleep: float = GOSSIP_SLEEP):
        super().__init__()
        self.cs = cs
        self.gossip_sleep = gossip_sleep
        self.wait_sync = False      # True while blocksync owns the chain
        self._peer_tasks: dict[str, list[asyncio.Task]] = {}
        self._last_nrs = None
        # per-tag message counters, pre-bound (the tag comes off the
        # wire, so only the closed protocol set gets a label — anything
        # else lands in "other" rather than minting attacker-chosen
        # label values)
        mt = _msg_type_metric()
        self._m_msgs = {tag: mt.bind(type=tag, node=cs.name)
                        for tag in _KNOWN_TAGS}
        self._m_msgs_other = mt.bind(type="other", node=cs.name)
        cs.broadcast_proposal = self._broadcast_proposal
        cs.broadcast_block_part = self._broadcast_block_part
        cs.broadcast_vote = self._broadcast_vote
        cs.on_round_step = self._broadcast_new_round_step
        cs.on_vote_added = self._broadcast_has_vote
        cs.on_valid_block = self._broadcast_new_valid_block
        cs.on_peer_misbehavior = self._on_peer_misbehavior

    def get_channels(self):
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6,
                              send_queue_capacity=100, name="state"),
            ChannelDescriptor(DATA_CHANNEL, priority=10,
                              send_queue_capacity=100, name="data"),
            ChannelDescriptor(VOTE_CHANNEL, priority=7,
                              send_queue_capacity=200, name="vote"),
            ChannelDescriptor(VOTE_SET_BITS_CHANNEL, priority=1,
                              send_queue_capacity=20, name="votesetbits"),
        ]

    # ------------------------------------------------------ peer lifecycle

    def add_peer(self, peer) -> None:
        peer.set("cons_peer_state", PeerState(
            rng=random.Random(f"gossip:{self.cs.name}:{peer.id}")))
        # gossip-efficiency children, pre-bound per peer (the label is
        # the same 12-char prefix the p2p telemetry uses)
        from ..p2p.metrics import peer_label

        pl = peer_label(peer.id)
        peer.set("m_dup_votes",
                 _dup_votes_metric().bind(peer=pl, node=self.cs.name))
        peer.set("m_useful_votes",
                 _useful_votes_metric().bind(peer=pl, node=self.cs.name))
        if not self.wait_sync:
            peer.send(STATE_CHANNEL, self._nrs_msg())
            nvb = self._nvb_msg()
            if nvb is not None:
                peer.send(STATE_CHANNEL, nvb)
        self._peer_tasks[peer.id] = [
            asyncio.create_task(self._gossip_data_routine(peer)),
            asyncio.create_task(self._gossip_votes_routine(peer)),
            asyncio.create_task(self._query_maj23_routine(peer)),
        ]

    def remove_peer(self, peer, reason=None) -> None:
        for task in self._peer_tasks.pop(peer.id, []):
            task.cancel()

    _MISBEHAVIOR_EVENTS = {"vote": "invalid_vote", "part": "invalid_part",
                           "proposal": "invalid_proposal"}

    def _on_peer_misbehavior(self, peer_id: str, kind: str,
                             exc: Exception) -> None:
        """A peer-fed consensus message made its handler raise.  Only
        VALIDATION failures (bad vote/proposal signature, part with a
        bad merkle proof) are the sender's fault — a quorum-completing
        vote runs commit + ABCI inline, and a flapping app's
        ConnectionResetError must not blame whichever honest peer's
        vote happened to land last."""
        sw = self.switch
        if sw is None or not hasattr(sw, "report_peer"):
            return
        from ..types.part_set import PartSetError
        from ..types.vote_set import VoteSetError

        if not isinstance(exc, (VoteSetError, PartSetError)):
            return
        event = self._MISBEHAVIOR_EVENTS.get(kind, "protocol_error")
        sw.report_peer(peer_id, event, detail=f"{kind}: {exc!r}"[:160])

    async def stop(self) -> None:
        for tasks in self._peer_tasks.values():
            for t in tasks:
                t.cancel()
        self._peer_tasks.clear()

    # -------------------------------------------------- outbound broadcasts

    def _nrs_msg(self) -> bytes:
        rs = self.cs.rs
        lcr = rs.last_commit.round if rs.last_commit is not None else -1
        return _pack("nrs", h=rs.height, r=rs.round, s=rs.step, lcr=lcr)

    def switch_to_consensus(self) -> None:
        """Blocksync handed the chain over: resume gossip and announce our
        (freshly synced) round state (reference SwitchToConsensus)."""
        self.wait_sync = False
        self._last_nrs = None
        self._broadcast_new_round_step()

    def _nvb_msg(self) -> bytes | None:
        """NewValidBlockMessage analogue (reactor.go
        broadcastNewValidBlockMessage): advertise which parts of the
        to-be-committed block we actually hold, so peers whose bookkeeping
        drifted (parts sent before we had the part-set header were dropped)
        re-send the gap.  Without this a catch-up node that enters COMMIT
        after the parts went by deadlocks waiting for a block nobody will
        re-send."""
        rs = self.cs.rs
        if rs.proposal_block_parts is None:
            return None
        return _pack(
            "nvb", h=rs.height, r=rs.round,
            psh=codec.to_dict(rs.proposal_block_parts.header()),
            bits=_ba_to_wire(rs.proposal_block_parts.bit_array()))

    def _broadcast_new_round_step(self) -> None:
        if self.switch is None or self.wait_sync:
            return
        nrs = self._nrs_msg()
        if nrs == self._last_nrs:
            return
        self._last_nrs = nrs
        self.switch.broadcast(STATE_CHANNEL, nrs)

    def _broadcast_new_valid_block(self) -> None:
        if self.switch is None or self.wait_sync:
            return
        nvb = self._nvb_msg()
        if nvb is not None:
            # peers track us against our announced round state: make sure
            # it precedes the nvb even if the step transition was deduped
            self.switch.broadcast(STATE_CHANNEL, self._nrs_msg())
            self.switch.broadcast(STATE_CHANNEL, nvb)

    def _broadcast_has_vote(self, vote: Vote) -> None:
        if self.switch is None:
            return
        self.switch.broadcast(STATE_CHANNEL, _pack(
            "hv", h=vote.height, r=vote.round, t=vote.type,
            i=vote.validator_index))

    def _broadcast_proposal(self, proposal) -> None:
        if self.switch is None:
            return
        self.switch.broadcast(DATA_CHANNEL,
                              _pack("prop", p=codec.to_dict(proposal)))

    def _broadcast_block_part(self, height: int, round_: int,
                              part: Part) -> None:
        if self.switch is None:
            return
        self.switch.broadcast(DATA_CHANNEL, _pack(
            "part", h=height, r=round_, p=_part_to_wire(part)))

    def _broadcast_vote(self, vote: Vote) -> None:
        if self.switch is None:
            return
        self.switch.broadcast(VOTE_CHANNEL,
                              _pack("vote", v=codec.to_dict(vote)))

    # -------------------------------------------------------------- receive

    def receive(self, channel_id: int, peer, msg: bytes) -> None:
        ps: PeerState = peer.get("cons_peer_state")
        if ps is None:
            return
        if self.wait_sync:
            # blocksync owns the chain: consensus traffic would pile up in
            # the unstarted state machine's queue (reference Reactor.Receive
            # drops messages while WaitSync)
            return
        d = _unpack(msg)
        tag = d.get("@")
        # wire-supplied tag may be any msgpack value: an unhashable one
        # must count as "other", not raise out of receive() and tear
        # down the connection
        ((self._m_msgs.get(tag) if isinstance(tag, str) else None)
         or self._m_msgs_other).inc()
        n_vals = self.cs.state.validators.size() \
            if self.cs.state is not None else 0
        if channel_id == STATE_CHANNEL:
            if tag == "nrs":
                ps.apply_new_round_step(d["h"], d["r"], d["s"], d["lcr"])
            elif tag == "hv":
                ps.set_has_vote(d["h"], d["r"], d["t"], d["i"], n_vals)
            elif tag == "nvb":
                if d["h"] == ps.height and d["r"] == ps.round:
                    ps.proposal_block_parts_header = codec.from_dict(d["psh"])
                    ps.proposal_block_parts = _ba_from_wire(d["bits"])
            elif tag == "maj23":
                self._on_vote_set_maj23(peer, d)
        elif channel_id == DATA_CHANNEL:
            if tag == "prop":
                proposal = codec.from_dict(d["p"])
                ps.proposal = True
                if ps.proposal_block_parts is None:
                    ps.proposal_block_parts_header = \
                        proposal.block_id.part_set_header
                    ps.proposal_block_parts = BitArray(
                        proposal.block_id.part_set_header.total)
                ps.proposal_pol_round = proposal.pol_round
                self.cs.feed_proposal(proposal, peer.id)
            elif tag == "pol":
                if d["h"] == ps.height:
                    ps.proposal_pol_round = d["polr"]
                    ps.proposal_pol = _ba_from_wire(d["pol"])
            elif tag == "part":
                part = _part_from_wire(d["p"])
                if ps.proposal_block_parts is not None:
                    ps.proposal_block_parts.set_index(part.index, True)
                self.cs.feed_block_part(d["h"], d["r"], part, peer.id)
        elif channel_id == VOTE_CHANNEL:
            if tag == "vote":
                vote = codec.from_dict(d["v"])
                ps.set_has_vote(vote.height, vote.round, vote.type,
                                vote.validator_index, n_vals)
                if self.cs.has_exact_vote(vote):
                    # re-gossip of a vote we already hold: the peer
                    # bookkeeping above is all it was worth — don't buy
                    # a WAL write, a queue slot and a dup-check pass
                    peer.gossip.duplicate += 1
                    m = peer.get("m_dup_votes")
                    if m is not None:
                        m.inc()
                    else:
                        _dup_votes_metric().inc()
                    return
                peer.gossip.useful += 1
                m = peer.get("m_useful_votes")
                if m is not None:
                    m.inc()
                self.cs.feed_vote(vote, peer.id)
            elif tag == "commit":
                # whole-commit aggregate catch-up: verification happens
                # in the state machine (feed_commit -> VerifyCommitLight)
                self.cs.feed_commit(codec.from_dict(d["c"]), peer.id)
        elif channel_id == VOTE_SET_BITS_CHANNEL:
            if tag == "vsb":
                bits = _ba_from_wire(d["bits"])
                if bits is not None:
                    ps.apply_vote_set_bits(d["h"], d["r"], d["t"], bits)

    def _on_vote_set_maj23(self, peer, d: dict) -> None:
        """Record the claimed majority and reply with our bits for that
        BlockID (reactor.go Receive StateChannel VoteSetMaj23Message)."""
        cs = self.cs
        h, r, typ = d["h"], d["r"], d["t"]
        bid = codec.from_dict(d["bid"])
        if cs.rs.height != h or cs.rs.votes is None:
            return
        try:
            cs.rs.votes.set_peer_maj23(r, typ, peer.id, bid)
        except Exception:
            return
        vs = (cs.rs.votes.prevotes(r) if typ == PREVOTE_TYPE
              else cs.rs.votes.precommits(r))
        bits = vs.bit_array_by_block_id(bid) if vs is not None else None
        peer.send(VOTE_SET_BITS_CHANNEL, _pack(
            "vsb", h=h, r=r, t=typ, bits=_ba_to_wire(
                bits or BitArray(cs.state.validators.size()))))

    # ------------------------------------------------------- gossip: data

    async def _gossip_data_routine(self, peer) -> None:
        ps: PeerState = peer.get("cons_peer_state")
        try:
            while True:
                rs = self.cs.rs
                sent = False
                if ps.height and ps.height < rs.height:
                    sent = self._send_catchup_part(peer, ps)
                elif ps.height == rs.height:
                    sent = self._send_current_data(peer, ps)
                if not sent:
                    await clock.sleep(self.gossip_sleep)
                else:
                    await clock.sleep(0)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass        # peer is being torn down

    def _send_catchup_part(self, peer, ps: PeerState) -> bool:
        """Feed a lagging peer parts of its next block from our store
        (gossipDataForCatchup, reactor.go:590)."""
        if ps.proposal_block_parts is None:
            # announce the stored block's part-set header so the peer's
            # state mirrors a proposal for its height
            parts = self.cs.block_store.load_block_parts(ps.height)
            if parts is None:
                return False
            ps.proposal_block_parts_header = parts.header()
            ps.proposal_block_parts = BitArray(parts.total)
        parts = self.cs.block_store.load_block_parts(ps.height)
        if parts is None or \
                parts.header() != ps.proposal_block_parts_header:
            return False
        want = parts.bit_array().sub(ps.proposal_block_parts)
        idx, ok = want.pick_random(ps.rng)
        if not ok:
            return False
        part = parts.get_part(idx)
        ps.proposal_block_parts.set_index(idx, True)
        return peer.send(DATA_CHANNEL, _pack(
            "part", h=ps.height, r=ps.round, p=_part_to_wire(part)))

    def _send_current_data(self, peer, ps: PeerState) -> bool:
        rs = self.cs.rs
        if rs.proposal is not None and not ps.proposal:
            ps.proposal = True
            # SetHasProposal (peer_state.go): knowing the part-set header
            # unlocks part gossip to this peer on the NEXT iteration.
            # Without this init, parts only flow once the peer's relay of
            # the proposal loops back to us — a full extra round-trip per
            # hop that starves prevotes of the block at net scale (found
            # by the scenario lab: at 25+ nodes most of the net entered
            # prevote with the proposal but zero parts, nil-prevoting
            # round after round).
            if ps.proposal_block_parts is None:
                ps.proposal_block_parts_header = \
                    rs.proposal.block_id.part_set_header
                ps.proposal_block_parts = BitArray(
                    rs.proposal.block_id.part_set_header.total)
            sent = peer.send(DATA_CHANNEL, _pack(
                "prop", p=codec.to_dict(rs.proposal)))
            if 0 <= rs.proposal.pol_round:
                pol = rs.votes.prevotes(rs.proposal.pol_round)
                if pol is not None:
                    peer.send(DATA_CHANNEL, _pack(
                        "pol", h=rs.height, polr=rs.proposal.pol_round,
                        pol=_ba_to_wire(pol.bit_array())))
            return sent
        if rs.proposal_block_parts is not None and \
                ps.proposal_block_parts is not None and \
                ps.proposal_block_parts_header == \
                rs.proposal_block_parts.header():
            want = rs.proposal_block_parts.bit_array().sub(
                ps.proposal_block_parts)
            idx, ok = want.pick_random(ps.rng)
            if ok:
                part = rs.proposal_block_parts.get_part(idx)
                ps.proposal_block_parts.set_index(idx, True)
                return peer.send(DATA_CHANNEL, _pack(
                    "part", h=rs.height, r=rs.round,
                    p=_part_to_wire(part)))
        return False

    # ------------------------------------------------------ gossip: votes

    async def _gossip_votes_routine(self, peer) -> None:
        ps: PeerState = peer.get("cons_peer_state")
        try:
            while True:
                if not self._send_vote_to_peer(peer, ps):
                    await clock.sleep(self.gossip_sleep)
                else:
                    await clock.sleep(0)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass

    def _send_vote_to_peer(self, peer, ps: PeerState) -> bool:
        """gossipVotesRoutine body (reactor.go:646)."""
        cs = self.cs
        rs = cs.rs
        if ps.height == 0:
            return False
        if ps.height == rs.height:
            # same height: last-commit for NewHeight peers, then POL
            # prevotes, round prevotes, round precommits
            if ps.step == STEP_NEW_HEIGHT and rs.last_commit is not None:
                if self._pick_send_vote(peer, ps, rs.last_commit):
                    return True
            if ps.step <= STEP_PREVOTE and ps.round != -1 and \
                    ps.round <= rs.round:
                if 0 <= ps.proposal_pol_round:
                    pol = rs.votes.prevotes(ps.proposal_pol_round)
                    if pol is not None and \
                            self._pick_send_vote(peer, ps, pol):
                        return True
                pv = rs.votes.prevotes(ps.round)
                if pv is not None and self._pick_send_vote(peer, ps, pv):
                    return True
            if ps.step <= STEP_PRECOMMIT and ps.round != -1 and \
                    ps.round <= rs.round:
                pc = rs.votes.precommits(ps.round)
                if pc is not None and self._pick_send_vote(peer, ps, pc):
                    return True
            if 0 <= ps.proposal_pol_round:
                pol = rs.votes.prevotes(ps.proposal_pol_round)
                if pol is not None and self._pick_send_vote(peer, ps, pol):
                    return True
            return False
        if ps.height + 1 == rs.height and rs.last_commit is not None:
            # peer is one height behind: our last commit has its precommits
            return self._pick_send_vote(peer, ps, rs.last_commit)
        if ps.height < rs.height:
            # catchup: stored commit for the peer's height
            commit = cs.block_store.load_block_commit(ps.height)
            if commit is None:
                seen = cs.block_store.load_seen_commit()
                if seen is not None and seen.height == ps.height:
                    commit = seen
            if commit is None:
                return False
            return self._pick_send_commit_vote(peer, ps, commit)
        return False

    def _pick_send_vote(self, peer, ps: PeerState, vote_set) -> bool:
        """Send one vote the peer lacks (PeerState.PickSendVote)."""
        ours = vote_set.bit_array()
        theirs = ps.vote_bits(vote_set.height, vote_set.round,
                              vote_set.type, ours.size)
        if theirs is None:
            return False
        idx, ok = ours.sub(theirs).pick_random(ps.rng)
        if not ok:
            return False
        vote = vote_set.get_by_index(idx)
        if vote is None:
            return False
        theirs.set_index(idx, True)
        return peer.send(VOTE_CHANNEL, _pack("vote", v=codec.to_dict(vote)))

    def _send_catchup_commit(self, peer, ps: PeerState,
                             commit: Commit) -> bool:
        """Ship a whole aggregated stored commit to a lagging peer: the
        folded lanes cannot be replayed vote-by-vote (their individual
        signatures no longer exist), so the peer verifies the commit as
        one unit instead.  Sent once per height, re-offered at a low
        rng-gated rate so one dropped message cannot strand the peer."""
        if ps.commit_sent_height == commit.height and \
                ps.rng.random() >= 0.02:
            return False
        if peer.send(VOTE_CHANNEL,
                     _pack("commit", c=codec.to_dict(commit))):
            ps.commit_sent_height = commit.height
            return True
        return False

    def _pick_send_commit_vote(self, peer, ps: PeerState,
                               commit: Commit) -> bool:
        if commit.has_aggregate() and \
                self._send_catchup_commit(peer, ps, commit):
            return True
        votes = votes_from_commit(commit)
        present = BitArray.from_indices(
            len(commit.signatures), [v.validator_index for v in votes])
        theirs = ps.vote_bits(commit.height, commit.round, PRECOMMIT_TYPE,
                              len(commit.signatures))
        if theirs is None:
            # peer's round state may not cover this commit round: track ad hoc
            ps.last_commit_round = commit.round
            ps.last_commit = theirs = BitArray(len(commit.signatures))
        idx, ok = present.sub(theirs).pick_random(ps.rng)
        if not ok:
            return False
        vote = next(v for v in votes if v.validator_index == idx)
        theirs.set_index(idx, True)
        return peer.send(VOTE_CHANNEL, _pack("vote", v=codec.to_dict(vote)))

    # ------------------------------------------------------- query maj23

    async def _query_maj23_routine(self, peer) -> None:
        ps: PeerState = peer.get("cons_peer_state")
        try:
            while True:
                await clock.sleep(QUERY_MAJ23_SLEEP
                                    * (0.8 + 0.4 * ps.rng.random()))
                rs = self.cs.rs
                if rs.votes is None or ps.height != rs.height:
                    continue
                for typ, vs in ((PREVOTE_TYPE, rs.votes.prevotes(rs.round)),
                                (PRECOMMIT_TYPE,
                                 rs.votes.precommits(rs.round))):
                    if vs is None:
                        continue
                    maj, has = vs.two_thirds_majority()
                    if has and maj is not None:
                        peer.send(STATE_CHANNEL, _pack(
                            "maj23", h=rs.height, r=rs.round, t=typ,
                            bid=codec.to_dict(maj)))
        except asyncio.CancelledError:
            raise
        except Exception:
            pass


# ---------------------------------------------------------- part wire codec

def _part_to_wire(part: Part) -> dict:
    return {"i": part.index, "b": part.bytes_,
            "pt": part.proof.total, "pi": part.proof.index,
            "pl": part.proof.leaf_hash, "pa": list(part.proof.aunts)}


def _part_from_wire(d: dict) -> Part:
    from ..crypto.merkle import Proof

    return Part(d["i"], d["b"],
                Proof(d["pt"], d["pi"], d["pl"], tuple(d["pa"])))
