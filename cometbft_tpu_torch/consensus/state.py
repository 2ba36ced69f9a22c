"""The Tendermint consensus state machine (counterpart of
``cometbft_tpu/consensus/state.py``; reference:
``internal/consensus/state.go``).

The reference's ``receiveRoutine`` goroutine maps to one asyncio task
consuming a queue of events (peer messages, own messages, timeouts, txs
available); everything that mutates the round state happens on that task.
WAL-before-processing ordering and the fsync rules (own votes reach disk
before they can be sent; EndHeightMessage is fsync'd before the block is
applied) follow ``state.go:830-869,1899``.  Round logic follows the
Tendermint rules of ``enterNewRound/enterPropose/defaultDoPrevote/
enterPrecommit/...`` (state.go:1056-1945), with locking and valid-block
bookkeeping, PBTS proposal timeliness and ABCI 2.0 vote extensions.

Every signature check reaches the device through the verification
scheduler (``crypto/scheduler.py``), which the caller registers before
starting a node: peers' votes are prefetched in micro-batches
(``submit_nowait``), the vote sets check through the cache
(``verify_cached``), and the proposal's signature is a fresh device lane
(``verify_uncached``).  Commit checks inside ``validate_block`` run on
the block executor's device.  The halting IO errors are the WAL's and
the file signer's sign-state errors (``privval/file.py``)."""

from __future__ import annotations

import asyncio
import errno
import time
from typing import Callable

from ..config import ConsensusConfig
from ..libs import clock
from ..libs import log as tmlog
from ..libs import metrics
from ..libs import tracing
from ..libs.pubsub import EventBus
from ..sm.execution import BlockExecutor
from ..sm.validation import BlockValidationError
from ..storage.blockstore import BlockStore
from ..storage.statestore import State
from ..types import codec
from ..types import events as ev
from ..types.block_id import BlockID
from ..types.commit import Commit, ExtendedCommit
from ..types.part_set import Part, PartSet
from ..types.priv_validator import PrivValidator
from ..types.vote import (PRECOMMIT_TYPE, PREVOTE_TYPE, Proposal, Vote)
from ..types.vote_set import ConflictingVoteError, VoteSetError
from .height_vote_set import HeightVoteSet
from .round_state import (STEP_COMMIT, STEP_NEW_HEIGHT, STEP_NEW_ROUND,
                          STEP_PRECOMMIT, STEP_PRECOMMIT_WAIT, STEP_PREVOTE,
                          STEP_PREVOTE_WAIT, STEP_PROPOSE, RoundState)
from .ticker import TimeoutInfo, TimeoutTicker
from .wal import WAL, WALError

__all__ = ["ConsensusState"]


class ConsensusState:
    def __init__(self, cfg: ConsensusConfig, state: State,
                 block_exec: BlockExecutor, block_store: BlockStore,
                 wal: WAL | None = None,
                 priv_validator: PrivValidator | None = None,
                 event_bus: EventBus | None = None,
                 now_ns: Callable[[], int] = clock.walltime_ns,
                 name: str = "cs"):
        self.cfg = cfg
        self.block_exec = block_exec
        self.block_store = block_store
        self.wal = wal
        self.priv_validator = priv_validator
        self.event_bus = event_bus or block_exec.event_bus
        self.now_ns = now_ns
        self.name = name
        self.log = tmlog.logger("consensus", node=name)
        # metrics.gen.go analogues for the consensus subsystem
        self.m_height = metrics.gauge(
            "consensus_height", "committed chain height")
        self.m_rounds = metrics.histogram(
            "consensus_rounds", "rounds needed per committed height",
            buckets=(0, 1, 2, 3, 5, 10, 20))
        self.m_block_interval = metrics.histogram(
            "consensus_block_interval_seconds",
            "wall time between commits",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30))
        self.m_errors = metrics.counter(
            "consensus_handler_errors_total", "recovered handler errors")
        self.m_step = metrics.histogram(
            "consensus_step_seconds",
            "wall time spent in each consensus step, by step name",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1, 2.5, 5, 10, 30))
        self.m_assembly = metrics.histogram(
            "consensus_block_assembly_seconds",
            "gossip block-part assembly time (first part -> complete)",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5))
        self.m_phase = metrics.histogram(
            "consensus_phase_seconds",
            "commit-latency attribution by phase, observed once per "
            "committed height (propose/gossip/prevote/precommit/commit/"
            "wal/app/total — the live-metrics face of the height "
            "timeline in libs/timeline)",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1, 2.5, 5, 10, 30))

        self.rs = RoundState()
        self.state: State | None = None
        self.queue: asyncio.Queue = asyncio.Queue()
        self.ticker = TimeoutTicker(self._deliver_timeout)
        self._task: asyncio.Task | None = None
        self._replaying = False
        self.fatal_error: Exception | None = None
        self._stopped = asyncio.Event()
        self.decided = asyncio.Event()      # pulses on every commit (tests)

        # outbound hooks (set by the in-proc harness or the p2p reactor)
        self.broadcast_proposal: Callable[[Proposal], None] = lambda p: None
        self.broadcast_block_part: Callable[[int, int, Part], None] = \
            lambda h, r, p: None
        self.broadcast_vote: Callable[[Vote], None] = lambda v: None
        self.on_conflicting_vote: Callable[[Vote, Vote], None] = \
            lambda a, b: None
        # fired when a PEER-fed message made a handler raise a
        # recoverable error (bad vote signature, malformed part, ...) —
        # the reactor maps (peer_id, kind, exc) onto the p2p peer-quality
        # scorer; default no-op keeps harness/test construction light
        self.on_peer_misbehavior: Callable[[str, str, Exception], None] = \
            lambda pid, kind, exc: None
        # reactor hooks: round-step transitions + votes added to our sets
        self.on_round_step: Callable[[], None] = lambda: None
        self.on_vote_added: Callable[[Vote], None] = lambda v: None
        # fired when we set up a part set for a block we don't hold yet
        # (the reference's EventValidBlock -> NewValidBlockMessage)
        self.on_valid_block: Callable[[], None] = lambda: None

        # timeline bookkeeping: the open flight-recorder span for the
        # current step, its (name, start) for the step-duration metric,
        # and the first-part arrival time of the assembling block
        self._step_span = None
        self._step_info: tuple[str, float] | None = None
        self._step_mono = clock.monotonic()
        self._assembly_t0: float | None = None
        # per-height phase marks (clock.monotonic seconds) feeding
        # consensus_phase_seconds at commit; reset in _update_to_state
        self._height_t0 = clock.monotonic()
        self._phase_marks: dict[str, float] = {}

        self._update_to_state(state)

    def _note_round_step(self) -> None:
        """Every ``rs.step`` transition funnels through here: close the
        previous step's metric + trace span, open the next one, then run
        the reactor's ``on_round_step`` hook."""
        now = clock.monotonic()
        rs = self.rs
        if self._replaying:
            # WAL catch-up drives hundreds of transitions in
            # milliseconds: recording them would flood
            # consensus_step_seconds with ~0s samples and evict the real
            # pre-restart timeline from the flight-recorder ring (same
            # reason replayed commits skip stats below)
            tracing.finish(self._step_span, replay_interrupted=True)
            self._step_span = None
            self._step_info = None
            self._step_mono = now
            self.on_round_step()
            return
        if self._step_info is not None:
            name, t0 = self._step_info
            self.m_step.observe(now - t0, step=name, node=self.name)
        tracing.finish(self._step_span)
        self._step_info = (rs.step_name(), now)
        self._step_mono = now
        self._step_span = tracing.begin(
            "consensus", "step", node=self.name, height=rs.height,
            round=rs.round, step=rs.step_name())
        self.on_round_step()

    def step_age_s(self) -> float:
        """Seconds the state machine has sat in the current step (the
        enriched ``/status`` surface: a large Propose/Prevote age on a
        live node means a stalled round)."""
        return max(0.0, clock.monotonic() - self._step_mono)

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        """WAL catch-up replay then launch the receive routine
        (state.go:322 OnStart)."""
        if self.wal is not None:
            await self._catchup_replay()
        self._task = asyncio.create_task(self._receive_routine())
        mp = getattr(self.block_exec, "mempool", None)
        if hasattr(mp, "on_txs_available"):
            # push edge from the mempool straight into the queue, fired
            # once per height on the first admitted tx (the reference
            # subscribes to mempool.TxsAvailable())
            mp.on_txs_available = self.notify_txs_available
        if STEP_PROPOSE <= self.rs.step <= STEP_PRECOMMIT_WAIT:
            # Replay ended MID-ROUND (a crash between the round's first
            # WAL record and its commit — the wal.fsync.eio chaos site
            # exposes this): own votes for this round may never have
            # been signed, replay never signs, and the NewHeight
            # timeout below would be discarded by the step guard — a
            # lone validator would wedge forever.  Re-enter the round
            # machinery LIVE through the precommit-wait path: it
            # advances to round+1, where nothing was ever signed (the
            # priv validator's last-sign state still guards round r
            # itself), so the node re-proposes/re-votes freshly instead
            # of waiting for gossip that a solo or fully-restarted net
            # can never produce.
            self.ticker.schedule(TimeoutInfo(
                1, self.rs.height, self.rs.round, STEP_PRECOMMIT_WAIT))
        else:
            self._schedule_round0_now()

    async def stop(self) -> None:
        self.ticker.stop()
        mp = getattr(self.block_exec, "mempool", None)
        if getattr(mp, "on_txs_available", None) is self.notify_txs_available:
            mp.on_txs_available = None
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self.wal is not None:
            try:
                self.wal.flush_and_sync()
            except Exception as e:
                # a dead WAL (fsyncgate halt) must not wedge stop(), but
                # a FIRST failure on this final flush is news: record it
                # loudly — buffered records the node acknowledged may
                # never have become durable
                if self.fatal_error is None:
                    self.fatal_error = e
                self.log.error("final WAL flush failed at stop",
                               err=repr(e))
        # close the open step span so the flight recorder shows the
        # final step of a stopped node instead of dropping it
        tracing.finish(self._step_span, stopped=True)
        self._step_span = None
        self._step_info = None

    # --------------------------------------------------------- public feeds

    def feed_proposal(self, proposal: Proposal, peer_id: str = "") -> None:
        self.queue.put_nowait(("proposal", proposal, peer_id))

    def feed_block_part(self, height: int, round_: int, part: Part,
                        peer_id: str = "") -> None:
        self.queue.put_nowait(("part", (height, round_, part), peer_id))

    def feed_vote(self, vote: Vote, peer_id: str = "") -> None:
        """Peer votes detour through the verification scheduler when one
        is running: the per-peer receive tasks are concurrent, so k peers'
        votes coalesce into one micro-batch and seed the verified-sig
        cache BEFORE the single-writer handler reaches ``VoteSet._verify``
        — the handler then pays a dict hit instead of a scalar
        multiplication.  Own votes (peer_id == "") and sync contexts
        (no running loop: tests, tooling) keep the direct enqueue."""
        if peer_id:
            from ..crypto import scheduler as _vsched

            sched = _vsched.get_scheduler()
            # with the cache disabled (max_size == 0) the prefetch verdict
            # can never reach VoteSet._verify — the detour would verify
            # every vote TWICE, so skip it entirely
            if sched is not None and sched.is_running \
                    and sched.cache.max_size > 0 \
                    and self._submit_prefetch(sched, vote, peer_id):
                return
        self.queue.put_nowait(("vote", vote, peer_id))

    def feed_commit(self, commit: Commit, peer_id: str = "") -> None:
        """Whole-commit catch-up feed: an aggregated stored commit cannot
        be replayed vote-by-vote (the folded BLS lanes carry no
        individual signatures), so the reactor ships it as one unit."""
        self.queue.put_nowait(("commit", commit, peer_id))

    def _submit_prefetch(self, sched, vote: Vote, peer_id: str) -> bool:
        """Fire-and-forget pre-verification of one gossiped vote; the
        vote enters the state queue once the verdict lands (a cache hit
        enqueues synchronously).  Only POSITIVE verdicts are cached — an
        invalid signature re-verifies inside ``VoteSet._verify`` and
        raises there, keeping the peer punishment path byte-identical.
        Returns False (caller enqueues directly) when the signer can't
        be resolved."""
        try:
            pub = self._vote_pub_key(vote)
            if pub is None or self.state is None:
                return False
            chain_id = self.state.chain_id
            # per-key-type domain: BLS votes sign zero-timestamp bytes,
            # so a prefetch over the reference bytes could never hit
            items = [(vote.sign_bytes_for(chain_id, pub.type()),
                      vote.signature)]
            if vote.extension_signature:
                items.append((vote.extension_sign_bytes(chain_id),
                              vote.extension_signature))
        except Exception:
            return False
        remaining = len(items)

        def _done(_ok: bool) -> None:
            nonlocal remaining
            remaining -= 1
            if remaining == 0:
                self.queue.put_nowait(("vote", vote, peer_id))

        for msg, sig in items:
            sched.submit_nowait(pub, msg, sig, on_done=_done,
                                height=vote.height)
        return True

    def _vote_pub_key(self, vote: Vote):
        """Resolve the signer for prefetch: current-height votes in the
        round validator set, previous-height precommits in
        last_validators.  Returns None when unresolvable (wrong height,
        bad index, address mismatch) — the state machine is the
        authority; prefetch just declines to warm the cache."""
        rs = self.rs
        if vote.height == rs.height:
            vals = rs.validators
        elif vote.height + 1 == rs.height and vote.type == PRECOMMIT_TYPE:
            vals = rs.last_validators
        else:
            return None
        if vals is None or not 0 <= vote.validator_index < vals.size():
            return None
        val = vals.get_by_index(vote.validator_index)
        if val is None or val.address != vote.validator_address:
            return None
        return val.pub_key

    def has_exact_vote(self, vote: Vote) -> bool:
        """True iff the matching vote set already holds this exact vote
        (same index, block and signature) — the reactor drops re-gossiped
        duplicates on this check before they buy a WAL write and a queue
        slot.  Conservative: any doubt returns False and the vote takes
        the full path."""
        rs = self.rs
        try:
            if vote.height == rs.height and rs.votes is not None:
                vs = (rs.votes.prevotes(vote.round)
                      if vote.type == PREVOTE_TYPE
                      else rs.votes.precommits(vote.round))
            elif vote.height + 1 == rs.height and \
                    vote.type == PRECOMMIT_TYPE:
                vs = rs.last_commit
            else:
                return False
            if vs is None:
                return False
            existing = vs.get_by_index(vote.validator_index)
            return (existing is not None
                    and existing.block_id == vote.block_id
                    and existing.signature == vote.signature)
        except Exception:
            return False

    def notify_txs_available(self) -> None:
        self.queue.put_nowait(("txs_available", None, ""))

    def _deliver_timeout(self, ti: TimeoutInfo) -> None:
        self.queue.put_nowait(("timeout", ti, ""))

    # ------------------------------------------------------- receive routine

    # consecutive handler failures before the node halts itself: a
    # deterministic bug must not become a silent infinite error loop
    MAX_CONSECUTIVE_ERRORS = 16

    # OSError errnos that mean the STORAGE layer failed (fsyncgate
    # class).  Deliberately narrow: ConnectionResetError/BrokenPipeError
    # /TimeoutError are OSError subclasses too (a socket-ABCI app
    # restarting mid-height must stay a recoverable handler error, not
    # a permanent halt).
    # no EBADF: a closed SOCKET can surface it too, and the WAL/LogDB
    # dead-handle flags already make every follow-up storage op loud
    _FATAL_IO_ERRNOS = frozenset(
        getattr(errno, name) for name in
        ("EIO", "ENOSPC", "EROFS", "EDQUOT", "ENXIO")
        if hasattr(errno, name))

    def _is_fatal_io_error(self, e: Exception) -> bool:
        """True iff ``e`` is a WAL/storage IO failure (halt consensus)
        rather than a transient handler error (count and continue).
        Provenance first — a dead WAL handle is definitive — then the
        storage errno class."""
        from ..privval.file import SignStateError

        if isinstance(e, (WALError, SignStateError)):
            # a sign-state persist failure is the same fsyncgate class:
            # the double-sign guard on disk may not reflect memory, so
            # signing anything further is unsafe until restart
            return True
        if isinstance(e, OSError):
            if self.wal is not None and \
                    getattr(self.wal, "_io_failed", None) is not None:
                return True
            return e.errno in self._FATAL_IO_ERRNOS
        return False

    async def _receive_routine(self) -> None:
        """state.go:788 — the single writer."""
        consecutive_errors = 0
        while True:
            kind, payload, peer = await self.queue.get()
            try:
                await self._handle(kind, payload, peer, replay=False)
                consecutive_errors = 0
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if self._is_fatal_io_error(e):
                    # fsyncgate: a WAL/storage IO failure is IMMEDIATELY
                    # fatal — durability of everything already
                    # acknowledged is unknown, and retrying fsync on the
                    # same fd can lie (the kernel dropped the dirty
                    # pages with the first error).  Halt so the watchdog
                    # bundles the evidence; recovery is a restart
                    # replaying the intact prefix.
                    self.fatal_error = e
                    self.ticker.stop()
                    self.log.error("HALT: consensus IO failure "
                                   "(fsyncgate)", kind=kind, err=repr(e))
                    return
                # recoverable: log and continue
                import traceback

                self.log.error("consensus handler error", kind=kind,
                               err=repr(e),
                               trace=traceback.format_exc(limit=4))
                self.m_errors.inc()
                if peer:
                    # the offending message came off the wire: let the
                    # reactor feed the peer-quality scorer (never let a
                    # scoring bug escalate a recoverable handler error)
                    try:
                        self.on_peer_misbehavior(peer, kind, e)
                    except Exception:
                        pass
                consecutive_errors += 1
                if consecutive_errors >= self.MAX_CONSECUTIVE_ERRORS:
                    # fatal: stop processing so the failure is observable
                    # (the reference dies and relies on WAL recovery)
                    self.fatal_error = e
                    self.ticker.stop()
                    self.log.error("HALT: consecutive consensus errors",
                                   count=consecutive_errors)
                    return

    async def _handle(self, kind: str, payload, peer: str,
                      replay: bool) -> None:
        if kind == "timeout":
            self._wal_write({"#": "timeout", "ti": {
                "d": payload.duration_ns, "h": payload.height,
                "r": payload.round, "s": payload.step}}, sync=True)
            await self._handle_timeout(payload)
            return
        if kind == "txs_available":
            await self._handle_txs_available()
            return
        # WAL-before-processing; own messages (peer == "") are fsync'd
        if not replay:
            self._wal_write({"#": kind, "peer": peer,
                             "data": _msg_to_wire(kind, payload)},
                            sync=(peer == ""))
        if kind == "proposal":
            await self._set_proposal(payload)
        elif kind == "part":
            h, r, part = payload
            await self._add_proposal_block_part(h, r, part)
        elif kind == "vote":
            await self._try_add_vote(payload, peer)
        elif kind == "commit":
            await self._handle_catchup_commit(payload, peer)

    # ------------------------------------------------------------------ WAL

    def _wal_write(self, rec: dict, sync: bool) -> None:
        if self.wal is None or self._replaying:
            return
        if sync:
            self.wal.write_sync(rec)
        else:
            self.wal.write(rec)

    async def _catchup_replay(self) -> None:
        """Re-drive recorded messages through the handlers (replay.go:95)."""
        height = self.rs.height
        try:
            records = self.wal.records_after_height(height - 1)
        except Exception:
            records = []
        self._replaying = True
        try:
            for rec in records:
                kind = rec.get("#")
                if kind == "timeout":
                    d = rec["ti"]
                    await self._handle_timeout(TimeoutInfo(
                        d["d"], d["h"], d["r"], d["s"]))
                elif kind in ("proposal", "part", "vote", "commit"):
                    await self._handle(kind,
                                       _msg_from_wire(kind, rec["data"]),
                                       rec.get("peer", ""), replay=True)
        finally:
            self._replaying = False

    # --------------------------------------------------------- state switch

    def _update_to_state(self, state: State) -> None:
        """state.go updateToState: advance to the next height."""
        ext_enabled = state.consensus_params.feature.vote_extensions_enabled(
            state.last_block_height + 1)
        height = state.last_block_height + 1 \
            if state.last_block_height else state.initial_height

        prev_precommits = None
        if self.rs.votes is not None and self.rs.commit_round >= 0 and \
                self.rs.height == state.last_block_height:
            prev_precommits = self.rs.votes.precommits(self.rs.commit_round)

        self.state = state
        self.rs = RoundState(
            height=height,
            round=0,
            step=STEP_NEW_HEIGHT,
            validators=state.validators.copy(),
            last_validators=(state.last_validators.copy()
                             if state.last_validators else None),
            votes=HeightVoteSet(state.chain_id, height, state.validators,
                                extensions_enabled=ext_enabled),
            last_commit=prev_precommits,
            commit_time_ns=self.now_ns(),
        )
        self.rs.start_time_ns = self.rs.commit_time_ns + \
            self.cfg.commit_timeout()
        self._height_t0 = clock.monotonic()
        self._phase_marks = {}
        self._note_round_step()

    def _schedule_round0_now(self) -> None:
        delay = max(self.rs.start_time_ns - self.now_ns(), 1)
        self.ticker.schedule(TimeoutInfo(delay, self.rs.height, 0,
                                         STEP_NEW_HEIGHT))

    # ------------------------------------------------------------- timeouts

    async def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """state.go:970 handleTimeout."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or \
                (ti.round == rs.round and ti.step < rs.step):
            return
        if ti.step == STEP_NEW_HEIGHT:
            await self._enter_new_round(ti.height, 0)
        elif ti.step == STEP_NEW_ROUND:
            await self._enter_propose(ti.height, 0)
        elif ti.step == STEP_PROPOSE:
            self.event_bus.publish(ev.EVENT_TIMEOUT_PROPOSE,
                                   {"height": ti.height, "round": ti.round})
            await self._enter_prevote(ti.height, ti.round)
        elif ti.step == STEP_PREVOTE_WAIT:
            self.event_bus.publish(ev.EVENT_TIMEOUT_WAIT,
                                   {"height": ti.height, "round": ti.round})
            await self._enter_precommit(ti.height, ti.round)
        elif ti.step == STEP_PRECOMMIT_WAIT:
            self.event_bus.publish(ev.EVENT_TIMEOUT_WAIT,
                                   {"height": ti.height, "round": ti.round})
            await self._enter_precommit(ti.height, ti.round)
            await self._enter_new_round(ti.height, ti.round + 1)

    async def _handle_txs_available(self) -> None:
        """state.go:1022 handleTxsAvailable."""
        rs = self.rs
        if rs.step == STEP_NEW_HEIGHT:
            # timeoutCommit phase: round 0 will propose anyway if a proof
            # block is needed; otherwise fast-path the schedule
            if not self._need_proof_block(rs.height):
                self._schedule_round0_now()
        elif rs.step == STEP_NEW_ROUND and rs.round == 0:
            # we were parked waiting for txs (create_empty_blocks off)
            await self._enter_propose(rs.height, 0)

    # ----------------------------------------------------------- new round

    async def _enter_new_round(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step != STEP_NEW_HEIGHT):
            return
        rs.round = round_
        rs.step = STEP_NEW_ROUND
        if round_ > 0:
            # reset proposal for the new round (keep valid block)
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_)
        rs.triggered_timeout_precommit = False
        self._note_round_step()
        self.event_bus.publish(ev.EVENT_NEW_ROUND,
                               {"height": height, "round": round_,
                                "proposer": self._round_proposer(
                                    round_).address.hex()})
        # wait for txs before proposing in round 0 (state.go:1110
        # waitForTxs): active when create_empty_blocks is off or an
        # interval is set, unless a proof block is needed
        wait_for_txs = ((not self.cfg.create_empty_blocks
                         or self.cfg.create_empty_blocks_interval > 0)
                        and round_ == 0
                        and not self._need_proof_block(height))
        if wait_for_txs and not self._mempool_has_txs():
            if self.cfg.create_empty_blocks_interval > 0:
                self.ticker.schedule(TimeoutInfo(
                    self.cfg.create_empty_blocks_interval, height, round_,
                    STEP_NEW_ROUND))
            return          # _handle_txs_available resumes us
        await self._enter_propose(height, round_)

    def _skip_timeout_commit(self) -> bool:
        return self.cfg.skip_timeout_commit or self.cfg.timeout_commit == 0

    def _need_proof_block(self, height: int) -> bool:
        """state.go:1124 needProofBlock: sign the genesis app hash right
        away, and propose an empty block whenever the previous block
        changed the app hash (so the new hash commits promptly).  Cached
        per height — the block decode is not free and both the round-0
        entry and txs_available consult it."""
        cached = getattr(self, "_proof_block_cache", None)
        if cached is not None and cached[0] == height:
            return cached[1]
        if height == self.state.initial_height:
            verdict = True
        else:
            prev = self.block_store.load_block(height - 1)
            verdict = (prev is None
                       or prev.header.app_hash != self.state.app_hash)
        self._proof_block_cache = (height, verdict)
        return verdict

    def _mempool_has_txs(self) -> bool:
        mp = getattr(self.block_exec, "mempool", None)
        size = getattr(mp, "size", None)
        return bool(size and size())

    def _round_proposer(self, round_: int):
        vals = self.state.validators
        if round_ == 0:
            return vals.get_proposer()
        return vals.copy_increment_proposer_priority(round_).get_proposer()

    def _is_our_turn(self, round_: int) -> bool:
        if self.priv_validator is None:
            return False
        return self._round_proposer(round_).address == \
            self.priv_validator.get_pub_key().address()

    # -------------------------------------------------------------- propose

    async def _enter_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PROPOSE):
            return
        rs.step = STEP_PROPOSE
        self._note_round_step()
        self.ticker.schedule(TimeoutInfo(self.cfg.propose_timeout(round_),
                                         height, round_, STEP_PROPOSE))
        if self._is_our_turn(round_):
            await self._decide_proposal(height, round_)
        if rs.proposal_complete():
            await self._enter_prevote(height, round_)

    async def _decide_proposal(self, height: int, round_: int) -> None:
        """state.go:1219 defaultDecideProposal."""
        if self._replaying:
            # replay mode never re-proposes: the recorded proposal/parts
            # will come through the WAL (replay.go; state.go replayMode)
            return
        rs = self.rs
        if rs.valid_block is not None:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            last_ext = self._last_extended_commit()
            if last_ext is None:
                return
            block, parts = await self.block_exec.create_proposal_block(
                height, self.state, last_ext,
                self.priv_validator.get_pub_key().address(), self.now_ns())
        bid = BlockID(block.hash(), parts.header())
        proposal = Proposal(height=height, round=round_,
                            pol_round=rs.valid_round, block_id=bid,
                            timestamp_ns=block.header.time_ns)
        try:
            await self.priv_validator.sign_proposal(self.state.chain_id,
                                                    proposal)
        except Exception as e:
            if self._is_fatal_io_error(e):
                raise        # privval fsyncgate: halt, see _sign_add_vote
            # a refusing signer skips the proposal, it does not crash the
            # round (defaultDecideProposal logs and returns on sign error)
            self.log.warn("sign_proposal refused", err=repr(e))
            return
        # own proposal: deliver to self (WAL-synced) + broadcast
        await self._handle("proposal", proposal, "", replay=False)
        for i in range(parts.total):
            await self._handle("part", (height, round_, parts.get_part(i)),
                               "", replay=False)
        if not self._replaying:
            self.broadcast_proposal(proposal)
            for i in range(parts.total):
                self.broadcast_block_part(height, round_, parts.get_part(i))

    def _last_extended_commit(self) -> ExtendedCommit | None:
        """Commit for height-1 used when proposing (from our own precommit
        set, or the block store after catch-up)."""
        rs = self.rs
        if rs.height == self.state.initial_height:
            return ExtendedCommit(0, 0, BlockID(), [])
        if rs.last_commit is not None and \
                rs.last_commit.has_two_thirds_majority():
            return rs.last_commit.make_extended_commit()
        stored = self.block_store.load_block_extended_commit(rs.height - 1)
        if stored is not None:
            return stored
        seen = self.block_store.load_seen_commit()
        if seen is not None and seen.height == rs.height - 1:
            if self.state.consensus_params.feature.vote_extensions_enabled(
                    rs.height - 1):
                # A plain commit cannot be promoted when extensions were
                # required at that height (types/block.go EnsureExtensions):
                # the fabricated ExtendedCommitSigs would carry no
                # extensions and the proposal would be invalid.
                return None
            from ..types.commit import ExtendedCommitSig

            # agg fields ride along: an aggregated seen commit's folded
            # lanes have no individual signatures, so the promotion must
            # keep the aggregate or the next proposal's last_commit would
            # be unverifiable
            return ExtendedCommit(seen.height, seen.round, seen.block_id,
                                  [ExtendedCommitSig(cs)
                                   for cs in seen.signatures],
                                  seen.agg_signature, seen.agg_signers)
        return None

    # ------------------------------------------------------------ proposal rx

    async def _set_proposal(self, proposal: Proposal) -> None:
        """state.go setProposal + defaultSetProposal."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or \
                (proposal.pol_round >= proposal.round):
            return
        proposer = self._round_proposer(rs.round)
        # a fresh device lane, never the cache (crypto/scheduler.py)
        from ..crypto import scheduler as _vsched

        if not _vsched.verify_uncached(
                proposer.pub_key, proposal.sign_bytes(self.state.chain_id),
                proposal.signature):
            raise VoteSetError("invalid proposal signature")
        rs.proposal = proposal
        rs.proposal_receive_time_ns = self.now_ns()
        if not self._replaying:
            self._phase_marks["proposal"] = clock.monotonic()
            tracing.event("consensus", "proposal_received",
                          node=self.name, height=rs.height,
                          round=rs.round)
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(
                proposal.block_id.part_set_header)

    async def _add_proposal_block_part(self, height: int, round_: int,
                                       part: Part) -> None:
        rs = self.rs
        if height != rs.height:
            return
        if rs.proposal_block_parts is None:
            return              # parts before proposal: dropped (gossip re-sends)
        if rs.proposal_block_parts.count == 0:
            self._assembly_t0 = time.perf_counter()
        try:
            added = rs.proposal_block_parts.add_part(part)
        except Exception:
            return
        if not added or not rs.proposal_block_parts.is_complete():
            return
        if self._assembly_t0 is not None:
            dt = time.perf_counter() - self._assembly_t0
            self._assembly_t0 = None
            if not self._replaying:     # replayed parts aren't gossip
                self.m_assembly.observe(dt, node=self.name)
                self._phase_marks["parts"] = clock.monotonic()
                tracing.event("consensus", "block_assembled",
                              node=self.name, height=height,
                              round=rs.round,
                              parts=rs.proposal_block_parts.total,
                              dur_us=int(dt * 1e6))
        rs.proposal_block = codec.unpack(rs.proposal_block_parts.get_data())
        self.event_bus.publish(ev.EVENT_COMPLETE_PROPOSAL,
                               {"height": height,
                                "hash": rs.proposal_block.hash().hex()})
        await self._handle_complete_proposal(height)

    async def _handle_complete_proposal(self, height: int) -> None:
        """state.go handleCompleteProposal."""
        rs = self.rs
        prevotes = rs.votes.prevotes(rs.round)
        maj, has_maj = (prevotes.two_thirds_majority()
                        if prevotes else (None, False))
        if has_maj and maj is not None and not maj.is_nil() and \
                rs.valid_round < rs.round:
            if rs.proposal_block.hash() == maj.hash:
                rs.valid_round = rs.round
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
        if rs.step <= STEP_PROPOSE and rs.proposal_complete():
            await self._enter_prevote(height, rs.round)
        elif rs.step == STEP_COMMIT:
            await self._try_finalize_commit(height)

    # -------------------------------------------------------------- prevote

    async def _enter_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PREVOTE):
            return
        rs.step = STEP_PREVOTE
        self._note_round_step()
        await self._do_prevote(height, round_)
        await self._recheck_step_thresholds()

    async def _recheck_step_thresholds(self) -> None:
        """Level-triggered catch-up for a validator that (re)enters a
        step AFTER the round's 2/3 threshold was already crossed — a
        mid-round restart rejoining a wedged height (the storage
        doctor's repair-then-refetch path ends exactly here), or a
        blocksync handoff into a live round.  Every transition below is
        normally edge-triggered from ``_on_{prevote,precommit}_added``;
        when the deciding votes landed while we were still in an
        earlier step — and our own (re)vote de-duplicates away because
        the privval returns the stored signature — no vote-add edge
        will ever fire them again."""
        rs = self.rs
        if rs.step == STEP_PREVOTE:
            prevotes = rs.votes.prevotes(rs.round)
            if prevotes is not None:
                maj, has_maj = prevotes.two_thirds_majority()
                if has_maj and maj is not None and \
                        (rs.proposal_complete() or maj.is_nil()):
                    await self._enter_precommit(rs.height, rs.round)
                elif prevotes.has_two_thirds_any():
                    await self._enter_prevote_wait(rs.height, rs.round)
        if rs.step == STEP_PRECOMMIT:
            precommits = rs.votes.precommits(rs.round)
            if precommits is None:
                return
            maj, has_maj = precommits.two_thirds_majority()
            if has_maj and maj is not None:
                if not maj.is_nil():
                    await self._enter_commit(rs.height, rs.round)
                else:
                    await self._enter_precommit_wait(rs.height, rs.round)
            elif precommits.has_two_thirds_any():
                await self._enter_precommit_wait(rs.height, rs.round)

    async def _do_prevote(self, height: int, round_: int) -> None:
        """state.go:1380 defaultDoPrevote."""
        rs = self.rs
        # locked block: prevote it (L22/L28 with lock awareness)
        if rs.proposal is None or rs.proposal_block is None:
            await self._sign_add_vote(PREVOTE_TYPE, BlockID())
            return
        block = rs.proposal_block
        # proposal timestamp must equal the proposed block's header time
        # (defaultDoPrevote: a Byzantine proposer could otherwise commit an
        # arbitrary header time — the network validates the *proposal*
        # timestamp, so the block must carry the same one)
        if rs.proposal.timestamp_ns != block.header.time_ns:
            await self._sign_add_vote(PREVOTE_TYPE, BlockID())
            return
        pol = rs.proposal.pol_round
        if rs.locked_round == -1 or rs.locked_block is None:
            lock_allows = True
        elif rs.locked_block.hash() == block.hash():
            lock_allows = True
        elif pol >= 0:
            pol_votes = rs.votes.prevotes(pol)
            pol_maj, has = (pol_votes.two_thirds_majority()
                            if pol_votes else (None, False))
            lock_allows = (has and pol_maj is not None
                           and pol_maj.hash == block.hash()
                           and pol >= rs.locked_round)
        else:
            lock_allows = False

        valid = lock_allows
        if valid:
            try:
                self.block_exec.validate_block(self.state, block)
            except BlockValidationError:
                valid = False
        # PBTS timeliness applies only to fresh proposals (pol_round == -1);
        # reproposals of a polka'd block are exempt (reference
        # defaultDoPrevote) — re-checking them would hurt liveness.
        if valid and pol == -1 and \
                self.state.consensus_params.feature.pbts_enabled(height):
            valid = self.state.consensus_params.synchrony.in_timely_bounds(
                rs.proposal.timestamp_ns, rs.proposal_receive_time_ns,
                round_)
        if valid:
            valid = await self.block_exec.process_proposal(block, self.state)

        if valid:
            bid = BlockID(block.hash(), rs.proposal_block_parts.header())
            await self._sign_add_vote(PREVOTE_TYPE, bid)
        else:
            await self._sign_add_vote(PREVOTE_TYPE, BlockID())

    # ------------------------------------------------------------ precommit

    async def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PREVOTE_WAIT):
            return
        rs.step = STEP_PREVOTE_WAIT
        self._note_round_step()
        self.ticker.schedule(TimeoutInfo(self.cfg.prevote_timeout(round_),
                                         height, round_, STEP_PREVOTE_WAIT))

    async def _enter_precommit(self, height: int, round_: int) -> None:
        """state.go:1604."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PRECOMMIT):
            return
        rs.step = STEP_PRECOMMIT
        if not self._replaying:
            self._phase_marks["prevote_23"] = clock.monotonic()
        self._note_round_step()
        await self._do_precommit(height, round_)
        await self._recheck_step_thresholds()

    async def _do_precommit(self, height: int, round_: int) -> None:
        rs = self.rs
        prevotes = rs.votes.prevotes(round_)
        maj, has_maj = (prevotes.two_thirds_majority()
                        if prevotes else (None, False))
        if not has_maj:
            await self._sign_add_vote(PRECOMMIT_TYPE, BlockID())
            return
        if maj.is_nil():
            # +2/3 prevoted nil: precommit nil but KEEP the lock — the
            # reference removed all unlock rules (locks reset only in
            # updateToState) to match the proven Tendermint algorithm.
            await self._sign_add_vote(PRECOMMIT_TYPE, BlockID())
            return
        if rs.locked_block is not None and \
                rs.locked_block.hash() == maj.hash:
            rs.locked_round = round_          # relock
            self.event_bus.publish(ev.EVENT_RELOCK, {"height": height})
            await self._sign_add_vote(PRECOMMIT_TYPE, maj)
            return
        if rs.proposal_block is not None and \
                rs.proposal_block.hash() == maj.hash:
            try:
                self.block_exec.validate_block(self.state, rs.proposal_block)
            except BlockValidationError:
                await self._sign_add_vote(PRECOMMIT_TYPE, BlockID())
                return
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            self.event_bus.publish(ev.EVENT_LOCK, {"height": height})
            await self._sign_add_vote(PRECOMMIT_TYPE, maj)
            return
        # +2/3 for a block we don't have: precommit nil, fetch via gossip
        await self._sign_add_vote(PRECOMMIT_TYPE, BlockID())

    async def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                rs.triggered_timeout_precommit:
            return
        rs.triggered_timeout_precommit = True
        self.ticker.schedule(TimeoutInfo(self.cfg.precommit_timeout(round_),
                                         height, round_,
                                         STEP_PRECOMMIT_WAIT))

    # --------------------------------------------------------------- commit

    async def _enter_commit(self, height: int, commit_round: int) -> None:
        """state.go:1738."""
        rs = self.rs
        if rs.height != height or rs.step == STEP_COMMIT:
            return
        rs.step = STEP_COMMIT
        rs.commit_round = commit_round
        if not self._replaying:
            self._phase_marks["precommit_23"] = clock.monotonic()
        self._note_round_step()
        rs.commit_time_ns = self.now_ns()
        precommits = rs.votes.precommits(commit_round)
        maj, _ = precommits.two_thirds_majority()
        # if we have the locked block and it is the committed one, promote it
        if rs.locked_block is not None and \
                rs.locked_block.hash() == maj.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        elif rs.proposal_block is None or \
                rs.proposal_block.hash() != maj.hash:
            # we don't have the block yet: set up parts to receive it and
            # re-announce our (empty) part bits so peers whose bookkeeping
            # marked parts as delivered re-send them (the reference fires
            # EventValidBlock here -> NewValidBlockMessage broadcast)
            if rs.proposal_block_parts is None or \
                    rs.proposal_block_parts.header() != maj.part_set_header:
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(maj.part_set_header)
                self.on_valid_block()
        await self._try_finalize_commit(height)

    async def _handle_catchup_commit(self, commit: Commit,
                                     peer: str) -> None:
        """A peer shipped a whole stored commit for our height (aggregate
        catch-up): the folded BLS lanes carry no individual signatures,
        so vote-by-vote catch-up can never reach +2/3 from an aggregated
        commit.  Verify the commit as one unit against this height's
        validator set and treat its block as decided — the block itself
        still arrives through normal part gossip."""
        rs = self.rs
        if self.state is None or commit is None or \
                commit.height != rs.height or \
                rs.decided_commit is not None:
            return
        if not commit.has_aggregate():
            return      # individual commits replay fine vote-by-vote
        err = commit.validate_basic()
        if err is not None:
            raise VoteSetError(f"catch-up commit: {err}")
        from ..types import validation as tval

        try:
            tval.VerifyCommitLight(
                self.state.chain_id, rs.validators, commit.block_id,
                commit.height, commit, device=self.block_exec.device,
                use_cache=False)
        except Exception as e:
            raise VoteSetError(f"catch-up commit rejected: {e}") from e
        rs.decided_commit = commit
        if rs.step != STEP_COMMIT:
            # mirror _enter_commit's block bookkeeping, with the commit's
            # BlockID standing in for the precommit majority
            rs.step = STEP_COMMIT
            rs.commit_round = commit.round
            rs.commit_time_ns = self.now_ns()
            if not self._replaying:
                self._phase_marks["precommit_23"] = clock.monotonic()
            self._note_round_step()
            maj = commit.block_id
            if rs.locked_block is not None and \
                    rs.locked_block.hash() == maj.hash:
                rs.proposal_block = rs.locked_block
                rs.proposal_block_parts = rs.locked_block_parts
            elif rs.proposal_block is None or \
                    rs.proposal_block.hash() != maj.hash:
                if rs.proposal_block_parts is None or \
                        rs.proposal_block_parts.header() != \
                        maj.part_set_header:
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet(maj.part_set_header)
                    self.on_valid_block()
        await self._try_finalize_commit(rs.height)

    async def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        dc = rs.decided_commit
        if dc is not None:
            if rs.proposal_block is not None and \
                    rs.proposal_block.hash() == dc.block_id.hash:
                await self._finalize_commit(height)
            return
        precommits = rs.votes.precommits(rs.commit_round)
        maj, has = precommits.two_thirds_majority()
        if not has or maj is None or maj.is_nil():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != maj.hash:
            return
        await self._finalize_commit(height)

    async def _finalize_commit(self, height: int) -> None:
        """state.go:1829 — save, WAL EndHeight, apply, advance."""
        rs = self.rs
        block, parts = rs.proposal_block, rs.proposal_block_parts
        bid = BlockID(block.hash(), parts.header())

        self.block_exec.validate_block(self.state, block)

        from ..libs.fail import fail_point

        fail_point("cs:before-save-block")    # state.go:1867-1936 sites
        if self.block_store.height() < height:
            if rs.decided_commit is not None:
                # aggregate catch-up: no local precommit votes exist —
                # save the verified received commit itself, as blocksync
                # does (the seen-commit promotion in
                # _last_extended_commit covers proposing from it)
                self.block_store.save_block(block, parts,
                                            rs.decided_commit)
            else:
                ext = rs.votes.precommits(
                    rs.commit_round).make_extended_commit()
                self.block_store.save_block_with_extended_commit(
                    block, parts, ext)
        fail_point("cs:after-save-block")
        t_wal0 = clock.monotonic()
        if self.wal is not None and not self._replaying:
            self.wal.write_end_height(height)
        t_wal = clock.monotonic() - t_wal0
        fail_point("cs:after-wal-endheight")

        new_state = await self.block_exec.apply_block(
            self.state, bid, block, verified=True)
        t_app = clock.monotonic() - t_wal0 - t_wal
        fail_point("cs:after-apply-block")

        # _update_to_state resets the phase marks for the next height:
        # capture this height's attribution first
        marks, t0h = self._phase_marks, self._height_t0
        t_commit = clock.monotonic()
        self._update_to_state(new_state)
        if not self._replaying:       # replayed commits would pollute stats
            now = self.now_ns()
            self.m_height.set(height, node=self.name)
            self.m_rounds.observe(rs.commit_round, node=self.name)
            last_wall = getattr(self, "_last_commit_wall_ns", 0)
            if last_wall:
                self.m_block_interval.observe(
                    max(now - last_wall, 0) / 1e9, node=self.name)
            self._last_commit_wall_ns = now
            self._observe_phases(marks, t0h, t_commit, t_wal, t_app)
            tracing.event("consensus", "commit", node=self.name,
                          height=height, round=rs.commit_round,
                          txs=len(block.data.txs),
                          catchup=rs.decided_commit is not None)
            self.log.debug("committed block", height=height,
                           round=rs.commit_round, hash=block.hash(),
                           n_txs=len(block.data.txs))
        self.decided.set()
        self.decided = asyncio.Event()
        self.decided_height = height
        self._schedule_round0_now()

    def _observe_phases(self, marks: dict, t0h: float, t_commit: float,
                        t_wal: float, t_app: float) -> None:
        """Fold one committed height's phase marks into
        ``consensus_phase_seconds{phase}`` — the always-on (metrics-only)
        face of the height timeline.  Missing marks (catch-up commits
        skip the vote phases; a restart loses the height start) skip
        their phase rather than observing a garbage duration."""
        bounds = [("propose", t0h)]
        for phase, key in (("gossip", "proposal"), ("prevote", "parts"),
                           ("precommit", "prevote_23"),
                           ("commit", "precommit_23")):
            m = marks.get(key)
            if m is not None:
                bounds.append((phase, max(m, bounds[-1][1])))
        for i, (phase, t) in enumerate(bounds):
            nxt = bounds[i + 1][1] if i + 1 < len(bounds) else t_commit
            self.m_phase.observe(max(0.0, min(nxt, t_commit) - t),
                                 phase=phase, node=self.name)
        self.m_phase.observe(max(0.0, t_wal), phase="wal", node=self.name)
        self.m_phase.observe(max(0.0, t_app), phase="app", node=self.name)
        self.m_phase.observe(max(0.0, t_commit - t0h), phase="total",
                             node=self.name)

    # ----------------------------------------------------------------- votes

    async def _sign_add_vote(self, typ: int, block_id: BlockID) -> None:
        """state.go:2587 signAddVote + vote extension handling (:2544)."""
        if self.priv_validator is None or self._replaying:
            # in replay mode recorded own votes arrive via the WAL; signing
            # fresh ones would equivocate on timestamp (state.go replayMode)
            return
        rs = self.rs
        addr = self.priv_validator.get_pub_key().address()
        idx, val = self.state.validators.get_by_address(addr)
        if idx < 0:
            return
        vote = Vote(type=typ, height=rs.height, round=rs.round,
                    block_id=block_id, timestamp_ns=self.now_ns(),
                    validator_address=addr, validator_index=idx)
        ext_enabled = self.state.consensus_params.feature \
            .vote_extensions_enabled(rs.height)
        sign_ext = False
        if typ == PRECOMMIT_TYPE and not block_id.is_nil() and ext_enabled:
            vote.extension = await self.block_exec.extend_vote(vote)
            sign_ext = True
        try:
            await self.priv_validator.sign_vote(self.state.chain_id, vote,
                                                sign_extension=sign_ext)
        except Exception as e:
            if self._is_fatal_io_error(e):
                # the sign-state file failed to persist (privval
                # fsyncgate): the signature was NOT released, and no
                # further signature may be — halt, don't skip-and-retry
                raise
            # a refusing signer (double-sign protection) or a timed-out
            # remote signer must not crash the state machine: skip the
            # vote like the reference (state.go signAddVote logs and
            # returns on sign error)
            self.log.warn("sign_vote refused", err=repr(e))
            return
        await self._handle("vote", vote, "", replay=False)
        if not self._replaying:
            self.broadcast_vote(vote)

    async def _try_add_vote(self, vote: Vote, peer: str) -> None:
        """state.go:2284 addVote."""
        rs = self.rs
        # late precommit for the previous height extends our last commit
        if vote.height + 1 == rs.height and vote.type == PRECOMMIT_TYPE:
            if rs.last_commit is not None:
                try:
                    rs.last_commit.add_vote(vote)
                except (VoteSetError, ConflictingVoteError):
                    pass
                else:
                    # all of last height's precommits in hand: skip the
                    # rest of timeout_commit (state.go:2325)
                    if self._skip_timeout_commit() and \
                            rs.last_commit.has_all():
                        await self._enter_new_round(rs.height, 0)
            return
        if vote.height != rs.height:
            return

        # verify extension for our-height precommits when enabled
        ext_enabled = self.state.consensus_params.feature \
            .vote_extensions_enabled(rs.height)
        if (ext_enabled and vote.type == PRECOMMIT_TYPE
                and not vote.block_id.is_nil()
                and peer != ""):
            if not await self.block_exec.verify_vote_extension(vote):
                raise VoteSetError("rejected vote extension")

        try:
            added = rs.votes.add_vote(vote, peer)
        except ConflictingVoteError as e:
            self.on_conflicting_vote(e.existing, e.new)
            return
        except VoteSetError:
            if peer == "":
                return          # replay of our own vote with drifted ts
            raise
        if not added:
            return
        self.event_bus.publish(ev.EVENT_VOTE, {"vote": vote})
        self.on_vote_added(vote)

        if vote.type == PREVOTE_TYPE:
            await self._on_prevote_added(vote)
        else:
            await self._on_precommit_added(vote)

    async def _on_prevote_added(self, vote: Vote) -> None:
        rs = self.rs
        prevotes = rs.votes.prevotes(vote.round)
        maj, has_maj = prevotes.two_thirds_majority()

        # valid-block bookkeeping (addVote): on +2/3 for a block in the
        # current round, record it as valid; if we don't hold it, reset the
        # part set so gossip can deliver it.  No unlocking here — the
        # reference deliberately removed all unlock rules.
        if has_maj and maj is not None and not maj.is_nil() and \
                rs.valid_round < vote.round and vote.round == rs.round:
            if rs.proposal_block is not None and \
                    rs.proposal_block.hash() == maj.hash:
                rs.valid_round = vote.round
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
            else:
                rs.proposal_block = None
                if rs.proposal_block_parts is None or \
                        rs.proposal_block_parts.header() != \
                        maj.part_set_header:
                    rs.proposal_block_parts = PartSet(maj.part_set_header)
                    self.on_valid_block()   # re-announce part bits (nvb)
            self.event_bus.publish(ev.EVENT_POLKA,
                                   {"height": rs.height,
                                    "round": vote.round})

        if vote.round > rs.round and prevotes.has_two_thirds_any():
            # skip ahead (the reference uses the 2/3-any condition)
            await self._enter_new_round(rs.height, vote.round)
        elif vote.round == rs.round and rs.step >= STEP_PREVOTE:
            # only precommit once the proposal is complete (or the polka is
            # nil) — otherwise wait for the block to arrive (addVote)
            if has_maj and maj is not None and \
                    (rs.proposal_complete() or maj.is_nil()):
                await self._enter_precommit(rs.height, vote.round)
            elif prevotes.has_two_thirds_any():
                await self._enter_prevote_wait(rs.height, vote.round)
        elif rs.proposal is not None and \
                0 <= rs.proposal.pol_round == vote.round and \
                rs.proposal_complete():
            # proposal's POL round just completed: we can now prevote
            await self._enter_prevote(rs.height, rs.round)

    async def _on_precommit_added(self, vote: Vote) -> None:
        rs = self.rs
        # snapshot the height THIS vote belongs to: any transition call
        # below may cascade clear through commit into the next height
        # (``_enter_precommit`` runs the level-triggered threshold
        # re-check), and a follow-up call made with the live ``rs.height``
        # would then target the NEW height with this height's round —
        # passing its guard and corrupting the fresh round's state
        h = rs.height
        precommits = rs.votes.precommits(vote.round)
        maj, has_maj = precommits.two_thirds_majority()
        if has_maj and maj is not None:
            await self._enter_new_round(h, vote.round)
            await self._enter_precommit(h, vote.round)
            if not maj.is_nil():
                await self._enter_commit(h, vote.round)
                # every precommit already in: start the next height now
                # (state.go:2489 skipTimeoutCommit)
                if self._skip_timeout_commit() and precommits.has_all():
                    await self._enter_new_round(self.rs.height, 0)
            else:
                await self._enter_precommit_wait(h, vote.round)
        elif precommits.has_two_thirds_any():
            if vote.round >= rs.round:
                await self._enter_new_round(h, vote.round)
                await self._enter_precommit_wait(h, vote.round)


# --------------------------------------------------------- WAL wire helpers

def _msg_to_wire(kind: str, payload):
    if kind in ("proposal", "vote", "commit"):
        return codec.to_dict(payload)
    if kind == "part":
        h, r, part = payload
        return {"h": h, "r": r, "i": part.index, "b": part.bytes_,
                "pt": part.proof.total, "pi": part.proof.index,
                "pl": part.proof.leaf_hash, "pa": part.proof.aunts}
    raise ValueError(kind)


def _msg_from_wire(kind: str, data):
    if kind in ("proposal", "vote", "commit"):
        return codec.from_dict(data)
    if kind == "part":
        from ..crypto.merkle import Proof

        part = Part(data["i"], data["b"],
                    Proof(data["pt"], data["pi"], data["pl"],
                          tuple(data["pa"])))
        return (data["h"], data["r"], part)
    raise ValueError(kind)
