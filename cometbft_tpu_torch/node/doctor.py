"""Storage integrity doctor: cross-store boot consistency, deep
hash-chain verification, and repair (counterpart of
``cometbft_tpu/node/doctor.py``).

The chaos plane makes the node *fail-stop* on storage errors;
salvage (storage/db.py) makes a corrupted store *readable* again.
Neither makes the survivors *trustworthy*: nothing verified that the
blockstore, statestore, WAL and privval last-sign-state still agree
after a crash, and a salvaged log can silently resurrect stale records
or lose tombstones.  The doctor closes that loop at every boot:

1. **Cross-store consistency** (`boot_check`): blockstore height/base
   vs statestore height vs WAL EndHeight lineage vs the privval
   last-sign-state, with the dangerous cases distinguished:

   - *privval ahead of everything* (sign state claims heights the
     stores never saw, and no in-flight corruption repair explains it):
     REFUSE to start.  The data dir regressed under a key that kept
     signing — the one recovery an operator must not reach for is
     resetting the sign state, because that is how validators
     double-sign.
   - *stores disagreeing*: roll the ahead store's view back to the max
     mutually-consistent height (blockstore tip truncation, or a
     statestore rebuild from the per-height validator/params/ABCI
     records) and let blocksync re-fetch the difference.
   - *WAL lineage ahead of the repaired stores*: quarantine the WAL —
     replaying records from a discarded timeline would feed consensus
     garbage; double-sign safety lives in the privval state, not the
     WAL.

2. **Deep scan** (`deep_scan`): walk the block hash chain
   (``header.last_block_id`` -> parent hash), the per-height
   meta/commit cross-references and the app-hash lineage (stored
   FinalizeBlock response vs the next header) over a configurable
   window back from the tip, and truncate to the last *verified* height
   on any mismatch.  Runs automatically whenever a store was salvaged
   (its ``.dirty`` marker is cleared only by a passing scan) and on
   demand via the offline ``doctor`` CLI subcommand.

The ABCI application is NOT rolled back by the doctor (same caveat as
the ``rollback`` command): after a truncating repair, a persistent app
that already executed the truncated heights needs its own rollback or a
resync.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field, replace as dc_replace


class DoctorError(Exception):
    """Refusal to start (or an unrepairable inconsistency).  Carries the
    report built so far in ``.report`` when available."""

    def __init__(self, msg: str, report: "DoctorReport | None" = None):
        super().__init__(msg)
        self.report = report


@functools.cache
def _doctor_metrics():
    from ..libs import metrics as m

    return m.counter("doctor_repairs_total",
                     "storage-doctor repair actions, by kind")


@dataclass
class DoctorReport:
    """What the doctor found and did, surfaced via ``/status`` (live and
    inspect mode) and the ``doctor`` CLI."""

    ok: bool = True
    refused: str | None = None
    heights: dict = field(default_factory=dict)
    salvage: dict = field(default_factory=dict)
    actions: list = field(default_factory=list)
    findings: list = field(default_factory=list)
    deep_scan: dict | None = None

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "refused": self.refused,
            "heights": dict(self.heights),
            "salvage": dict(self.salvage),
            "actions": list(self.actions),
            "findings": list(self.findings),
            "deep_scan": dict(self.deep_scan)
            if self.deep_scan is not None else None,
        }


class StorageDoctor:
    def __init__(self, block_store, state_store, *, wal_path: str | None
                 = None, priv_validator=None,
                 privval_state_path: str | None = None,
                 deep_scan_window: int = 128, name: str = "node"):
        self.block_store = block_store
        self.state_store = state_store
        self.wal_path = wal_path
        self.priv_validator = priv_validator
        self.privval_state_path = privval_state_path
        self.deep_scan_window = deep_scan_window
        from ..libs import log as tmlog

        self.log = tmlog.logger("doctor", node=name)

    # ------------------------------------------------------------ helpers

    def _privval_height(self, report: DoctorReport) -> int | None:
        """Last-sign height: from the live PrivValidator when it carries
        one (FilePV), else leniently from the state file (inspect/CLI
        mode, where an unreadable file is a FINDING, not a crash)."""
        if self.priv_validator is not None:
            h = getattr(self.priv_validator, "height", None)
            return h if isinstance(h, int) else None
        path = self.privval_state_path
        if path and os.path.exists(path):
            import json

            try:
                with open(path) as f:
                    return int(json.load(f)["height"])
            except (OSError, ValueError, KeyError, TypeError) as e:
                report.findings.append(
                    f"privval state file unreadable: {e!r} (do NOT reset "
                    f"it — restore from backup)")
        return None

    def _db_salvage_info(self, store_db) -> dict | None:
        salvaged = bool(getattr(store_db, "salvaged", False))
        dirty = getattr(store_db, "is_dirty", None)
        dirty = bool(dirty is not None and dirty())
        if not (salvaged or dirty):
            return None
        info = {"salvaged_this_open": salvaged, "dirty": dirty}
        spans = getattr(store_db, "salvage_spans", None)
        if spans:
            info["spans"] = [[lo, hi] for lo, hi in spans]
        get_info = getattr(store_db, "dirty_info", None)
        if not spans and get_info is not None:
            prev = get_info()
            if prev and prev.get("spans"):
                info["spans"] = prev["spans"]
        return info

    def _clear_dirty(self, which=("block", "state")) -> None:
        if "block" in which:
            self.block_store.clear_dirty()
        if "state" in which:
            fn = getattr(self.state_store.db, "clear_dirty", None)
            if fn is not None:
                fn()

    def _repair(self, report: DoctorReport, action: str, kind: str) -> None:
        report.actions.append(action)
        _doctor_metrics().inc(kind=kind)
        self.log.warn("storage doctor repair", action=action)

    # --------------------------------------------------------- boot check

    def boot_check(self, repair: bool = True,
                   raise_on_refusal: bool | None = None,
                   force_deep: bool = False,
                   deep_window: int | None = None) -> DoctorReport:
        """Fast cross-store consistency pass.  ``repair=True`` (node
        boot) fixes what it can and raises :class:`DoctorError` on the
        dangerous cases; ``repair=False`` (inspect / ``doctor`` without
        ``--repair``) only reports.  ``raise_on_refusal`` defaults to
        ``repair``.  ``force_deep`` runs the deep scan even on a clean
        store (the offline CLI always walks the chain); either way the
        WAL-lineage check runs LAST, against the post-repair heights."""
        if raise_on_refusal is None:
            raise_on_refusal = repair
        report = DoctorReport()
        bs, ss = self.block_store, self.state_store

        bs_salv = self._db_salvage_info(bs.db)
        ss_salv = self._db_salvage_info(ss.db)
        if bs_salv:
            report.salvage["blockstore"] = bs_salv
        if ss_salv:
            report.salvage["statestore"] = ss_salv
        any_dirty = bool(bs_salv or ss_salv)

        try:
            state = ss.load()
        except Exception as e:
            return self._refuse(report, raise_on_refusal,
                                f"statestore state record undecodable "
                                f"({e!r}): resync this node")
        bs_h, bs_base = bs.height(), bs.base()
        st_h = state.last_block_height if state is not None else 0
        wal_eh = None
        if self.wal_path:
            from ..consensus.wal import last_end_height

            wal_eh = last_end_height(self.wal_path)
        pv_h = self._privval_height(report)
        report.heights = {"blockstore": bs_h, "blockstore_base": bs_base,
                          "state": st_h, "wal_end_height": wal_eh,
                          "privval": pv_h}

        # ---- the double-sign tripwire: privval ahead of everything.
        # Tolerates the normal +1 (the signer votes for height h+1
        # while the stores still hold h).  A salvaged store explains a
        # larger gap (the repair below/deep scan re-fetches); a CLEAN
        # store that is behind what this key signed means the data dir
        # regressed underneath a live key — refuse, loudly.
        if pv_h is not None and pv_h > max(bs_h, st_h) + 1 and not any_dirty:
            return self._refuse(
                report, raise_on_refusal,
                f"privval last-sign state is at height {pv_h} but the "
                f"stores only reach {max(bs_h, st_h)}: the data dir "
                f"regressed under a key that kept signing (restored "
                f"backup?).  REFUSING to start.  Do NOT reset the "
                f"priv_validator state file to \"fix\" this — resetting "
                f"sign state is how validators double-sign.  Restore a "
                f"data dir that matches the sign state, or move this key "
                f"only after the network is provably past height {pv_h}.")

        if state is None and bs_h > 0:
            return self._refuse(
                report, raise_on_refusal,
                f"statestore is empty but the blockstore reaches {bs_h}: "
                f"state cannot be rebuilt locally — statesync or resync "
                f"this node")

        # ---- cross-store reconcile: roll the ahead store's view back
        # to the max mutually-consistent height; blocksync re-fetches.
        if state is not None and bs_h > st_h + 1:
            # blockstore ahead beyond the one-block crash window the
            # Handshaker covers: state for those blocks never persisted
            if st_h + 1 < bs_base:
                # a (possibly stale-resurrected) state below the pruned
                # base: truncating there would leave a store claiming a
                # tip it holds no blocks for
                return self._refuse(
                    report, raise_on_refusal,
                    f"state height {st_h} is below the blockstore base "
                    f"{bs_base}: cannot truncate below a pruned base — "
                    f"statesync or resync this node")
            if repair:
                removed = bs.truncate_above(st_h + 1)
                self._repair(
                    report,
                    f"blockstore ahead of state ({bs_h} > {st_h}+1): "
                    f"truncated {removed} blocks to {st_h + 1}; blocksync "
                    f"re-fetches", "truncate_ahead_blockstore")
                bs_h = bs.height()
            else:
                report.findings.append(
                    f"blockstore ahead of state ({bs_h} > {st_h}+1)")
        if state is not None and st_h > bs_h:
            # statestore ahead: the blockstore lost its tip (salvage
            # data loss).  Rebuild the state snapshot at the blockstore
            # tip from the per-height records.
            if repair:
                state = self._rebuild_state_at(report, state, bs_h,
                                               raise_on_refusal)
                if report.refused:
                    return report
                self._repair(
                    report,
                    f"state ahead of blockstore ({st_h} > {bs_h}): state "
                    f"rebuilt at {bs_h} from per-height records",
                    "rewind_state")
                st_h = bs_h
            else:
                report.findings.append(
                    f"state ahead of blockstore ({st_h} > {bs_h})")

        # ---- a salvaged store is only trustworthy after the deep
        # hash-chain walk: salvage can resurrect stale values or lose
        # tombstones that no per-record CRC can see.
        if any_dirty or force_deep:
            report.deep_scan = self.deep_scan(
                window=deep_window, repair=repair, report=report)
            if report.refused:
                report.ok = False
                if raise_on_refusal:
                    raise DoctorError(report.refused, report)
                return report
            if repair and report.deep_scan.get("ok") and any_dirty:
                self._clear_dirty()
                report.actions.append(
                    "deep scan verified the salvaged store; dirty "
                    "markers cleared")

        # ---- WAL lineage against the final (possibly repaired) view
        final_h = bs.height()
        if wal_eh is not None and wal_eh > final_h:
            if repair:
                from ..consensus.wal import quarantine_wal

                moved = quarantine_wal(self.wal_path)
                self._repair(
                    report,
                    f"WAL EndHeight {wal_eh} ahead of stores at {final_h}: "
                    f"{len(moved)} segments quarantined (replay from a "
                    f"discarded timeline is unsafe; privval state guards "
                    f"double-signing)", "quarantine_wal")
            else:
                report.findings.append(
                    f"WAL EndHeight {wal_eh} ahead of stores at {final_h}")

        report.ok = report.refused is None and (
            repair or (not report.findings
                       and not (report.deep_scan or {}).get("bad")))
        return report

    def _refuse(self, report: DoctorReport, raise_on_refusal: bool,
                msg: str) -> DoctorReport:
        report.refused = msg
        report.ok = False
        self.log.error("storage doctor refusal", reason=msg)
        if raise_on_refusal:
            raise DoctorError(msg, report)
        return report

    # ---------------------------------------------------------- deep scan

    def deep_scan(self, window: int | None = None, repair: bool = False,
                  report: DoctorReport | None = None) -> dict:
        """Walk the hash chain and app-hash lineage over ``window``
        heights back from the tip (0/None = config default; the config's
        0 means the whole store).  On mismatch with ``repair``: truncate
        the blockstore to the last verified height below the FIRST bad
        one (keeping the chain contiguous for app replay) and rebuild
        the state snapshot there; blocksync re-fetches the rest."""
        bs, ss = self.block_store, self.state_store
        if report is None:
            report = DoctorReport()
        if window is None:
            window = self.deep_scan_window
        top, base = bs.height(), max(bs.base(), 1)
        out: dict = {"window": [base, top], "scanned": 0, "bad": [],
                     "verified_to": None, "truncated_to": None, "ok": True}
        if top == 0:
            return out
        lo = base if window <= 0 else max(base, top - window + 1)
        out["window"] = [lo, top]

        if bs.load_block(top) is None and top == bs.base() \
                and bs.load_seen_commit() is not None:
            # statesync anchor: bookkeeping + trusted commit, no blocks.
            # Nothing to walk — and nothing this store can mis-serve.
            out["anchor_only"] = True
            return out

        try:
            state = ss.load()
        except Exception:
            state = None

        # the blockstore hash chain cannot vouch for the statestore's
        # per-height records — but the headers CAN: validators_hash and
        # consensus_hash commit to the validator-set and params records.
        # A salvaged statestore (dirty) gets that check; a stale
        # resurrected record is unrepairable locally (the content behind
        # the hash is gone), so a mismatch keeps the marker/refuses.
        ss_dirty = getattr(ss.db, "is_dirty", None)
        verify_state = bool(ss_dirty is not None and ss_dirty())
        state_ok = True

        bad: set[int] = set()
        upper_block = None          # block at h+1 (walking downward)
        upper_ok = False
        for h in range(top, lo - 1, -1):
            out["scanned"] += 1
            upper, upper_was_ok = upper_block, upper_ok
            upper_block, upper_ok = None, False     # until h verifies
            block = meta = None
            try:
                block = bs.load_block(h)
                meta = bs.load_block_meta(h)
            except Exception as e:
                report.findings.append(f"height {h}: undecodable ({e!r})")
            if block is None or meta is None:
                bad.add(h)
                report.findings.append(
                    f"height {h}: missing "
                    f"{'block' if block is None else 'meta'} record")
                continue
            bhash = block.hash()
            if meta.block_id.hash != bhash or block.header.height != h:
                bad.add(h)
                report.findings.append(
                    f"height {h}: block/meta mismatch (meta "
                    f"{meta.block_id.hash.hex()[:12]} vs header "
                    f"{bhash.hex()[:12]})")
                continue
            try:
                commit = bs.load_block_commit(h)
            except Exception:
                commit = False          # undecodable commit record
            if commit is False or (commit is not None
                                   and commit.block_id.hash != bhash):
                bad.add(h)
                report.findings.append(
                    f"height {h}: canonical commit does not certify the "
                    f"stored block")
                continue
            if commit is None and h < top:
                # save_block writes the canonical commit for h when
                # block h+1 lands, so below the tip its absence means a
                # lost record (the tip's commit legitimately lives only
                # in the seen-commit slot)
                bad.add(h)
                report.findings.append(
                    f"height {h}: canonical commit record missing")
                continue
            if upper is not None and upper_was_ok and h + 1 not in bad:
                # hash chain: the child header vouches for the parent
                if upper.header.last_block_id.hash != bhash:
                    bad.add(h + 1)
                    report.findings.append(
                        f"height {h + 1}: last_block_id does not match "
                        f"block {h} (hash chain broken)")
                else:
                    # app-hash lineage via the stored FinalizeBlock
                    # response, when one is present (they are optional:
                    # discard_abci_responses / pruned)
                    resp_app = self._resp_app_hash(h)
                    if resp_app is not None and \
                            upper.header.app_hash != resp_app:
                        bad.add(h + 1)
                        report.findings.append(
                            f"height {h + 1}: header app_hash breaks the "
                            f"stored response lineage at {h}")
            if verify_state:
                # the header commits to the per-height statestore
                # records: validators_hash / consensus_hash.  A missing
                # record degrades like pruning; a PRESENT-but-different
                # one is a stale resurrection
                try:
                    vals = ss.load_validators(h)
                except Exception:
                    vals = False
                if vals is False or (
                        vals is not None
                        and vals.hash() != block.header.validators_hash):
                    state_ok = False
                    report.findings.append(
                        f"height {h}: statestore validator-set record "
                        f"contradicts header validators_hash")
                try:
                    params = ss.load_params(h)
                except Exception:
                    params = False
                if params is False or (
                        params is not None
                        and params.hash() != block.header.consensus_hash):
                    state_ok = False
                    report.findings.append(
                        f"height {h}: statestore params record "
                        f"contradicts header consensus_hash")
            if h == top and state is not None and \
                    state.last_block_height == top and \
                    state.last_block_id.hash != bhash:
                bad.add(h)
                report.findings.append(
                    f"height {h}: state.last_block_id does not match the "
                    f"stored tip block")
            upper_block, upper_ok = block, True

        if verify_state:
            out["state_records_ok"] = state_ok
            if not state_ok:
                # unrepairable locally: the content behind the header
                # hashes is gone — never clear the dirty marker, and in
                # repair mode refuse outright (resync)
                out["ok"] = False
                out["bad"] = sorted(bad)
                if repair:
                    self._refuse(
                        report, False,
                        "salvaged statestore records contradict the "
                        "header hashes (stale resurrection): cannot be "
                        "rebuilt locally — statesync or resync this node")
                return out

        out["bad"] = sorted(bad)
        if not bad:
            out["verified_to"] = lo
            return out
        out["ok"] = False
        first_bad = min(bad)
        # the verified SUFFIX starts above the highest bad height (a
        # lower first_bad does not vouch for the corrupt ones above it)
        max_bad = max(bad)
        out["verified_to"] = max_bad + 1 if max_bad < top else None
        if not repair:
            return out

        target = first_bad - 1
        if first_bad <= bs.base() and bs.base() > 1:
            # the corruption reaches a pruned/statesync'd base: there is
            # nothing below to truncate to — only a resync recovers
            self._refuse(
                report, False,
                f"deep scan found corruption at height {first_bad}, at or "
                f"below the store base {bs.base()}: cannot truncate below "
                f"a pruned base — statesync or resync this node")
            out["ok"] = False
            return out
        removed = bs.truncate_above(target)
        if state is not None and state.last_block_height > target:
            state = self._rebuild_state_at(report, state, target,
                                           raise_on_refusal=False)
            if report.refused:
                out["ok"] = False
                return out
        self._repair(
            report,
            f"deep scan: heights {sorted(bad)} failed verification; "
            f"truncated {removed} blocks to last verified height "
            f"{target}; blocksync re-fetches", "truncate_unverified")
        out["truncated_to"] = target
        out["ok"] = True
        return out

    def _resp_app_hash(self, height: int) -> bytes | None:
        try:
            raw = self.state_store.load_finalize_block_response(height)
            if raw is None:
                return None
            from ..sm.execution import unpack_finalize_response

            return unpack_finalize_response(raw).app_hash
        except Exception:
            return None

    # ------------------------------------------------------- state rebuild

    def _rebuild_state_at(self, report: DoctorReport, state, target: int,
                          raise_on_refusal: bool):
        """Reconstruct and persist the state snapshot as of ``target``
        from the per-height records (validator sets, params, the stored
        FinalizeBlock response, the block meta) — the doctor's analogue
        of ``rollback_state`` for targets whose upper blocks are GONE
        (ordinary rollback needs the block being undone; a salvaged
        store lost it)."""
        bs, ss = self.block_store, self.state_store
        if target == 0:
            ss.clear_state()
            self._repair(report,
                         "state reset to genesis (no verified height "
                         "left); the node resyncs from scratch",
                         "reset_state")
            return None
        if target < bs.base():
            self._refuse(
                report, raise_on_refusal,
                f"cannot rebuild state at {target}: below the store base "
                f"{bs.base()} — statesync or resync this node")
            return state
        try:
            vals = ss.load_validators(target + 1)
            nvals = ss.load_validators(target + 2)
            lvals = ss.load_validators(target)
            params = ss.load_params(target + 1)
            meta = bs.load_block_meta(target)
            block = bs.load_block(target)
            raw = ss.load_finalize_block_response(target)
        except Exception as e:
            self._refuse(report, raise_on_refusal,
                         f"cannot rebuild state at {target}: per-height "
                         f"records undecodable ({e!r}) — resync this node")
            return state
        if vals is None or nvals is None or meta is None or block is None \
                or raw is None:
            self._refuse(
                report, raise_on_refusal,
                f"cannot rebuild state at {target}: missing per-height "
                f"records (validators/meta/block/ABCI response) — "
                f"statesync or resync this node")
            return state
        if meta.block_id.hash != block.hash():
            self._refuse(
                report, raise_on_refusal,
                f"cannot rebuild state at {target}: block/meta mismatch "
                f"at the rebuild anchor — resync this node")
            return state
        from ..sm.execution import unpack_finalize_response

        resp = unpack_finalize_response(raw)
        new_state = dc_replace(
            state,
            last_block_height=target,
            last_block_id=meta.block_id,
            last_block_time_ns=block.header.time_ns,
            validators=vals,
            next_validators=nvals,
            last_validators=lvals,
            last_height_validators_changed=min(
                state.last_height_validators_changed, target + 1),
            consensus_params=params if params is not None
            else state.consensus_params,
            last_height_params_changed=min(
                state.last_height_params_changed, target + 1),
            last_results_hash=resp.results_hash(),
            app_hash=resp.app_hash,
        )
        ss.save(new_state)
        return new_state
