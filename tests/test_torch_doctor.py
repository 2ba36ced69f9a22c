"""The port's storage doctor (``cometbft_tpu_torch/node/doctor.py``)
against the JAX package's, on the CPU: the cases of
``tests/test_doctor.py`` on the same damaged homes.  One solo-validator
home is committed by a JAX node (the LogDB files and the WAL are the
same bytes in both packages); each case damages a copy of it, copies the
damaged home twice, and runs each package's doctor on its own copy: the
reports, the raised refusals, and the stores and WAL segments the
repairs leave must be equal (a decoder's exception text aside).  Also:
a port node boots the repaired homes and keeps committing, serves the
report on ``/status``, and a salvaged store (a mid-log record
corrupted) is found dirty and cleared by both."""

import asyncio
import json
import os
import re
import shutil
import time
from dataclasses import replace as dc_replace

import pytest
import torch

import cometbft_tpu.consensus.wal as j_wal
import cometbft_tpu.node.doctor as j_doctor
import cometbft_tpu.storage as j_storage
import cometbft_tpu_torch.consensus.wal as t_wal
import cometbft_tpu_torch.node.doctor as t_doctor
import cometbft_tpu_torch.storage as t_storage
from cometbft_tpu.storage.blockstore import K_BLOCK
from cometbft_tpu.storage.db import height_key
from cometbft_tpu.storage.statestore import K_VALS

from torch_node_fixtures import no_host_verify  # noqa: F401

pytestmark = pytest.mark.timeout(150)

torch.set_num_threads(1)

HOME_SECRET = b"doctor-home-pv"


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _jax_doc_pv():
    from cometbft_tpu.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu.types.priv_validator import MockPV

    pv = MockPV.from_secret(HOME_SECRET)
    return GenesisDoc(chain_id="doctor-net", validators=[
        GenesisValidator(pv.get_pub_key(), 10)]), pv


def _port_doc_pv():
    from cometbft_tpu_torch.types.genesis import (GenesisDoc,
                                                  GenesisValidator)
    from cometbft_tpu_torch.types.priv_validator import MockPV

    pv = MockPV.from_secret(HOME_SECRET)
    return GenesisDoc(chain_id="doctor-net", validators=[
        GenesisValidator(pv.get_pub_key(), 10)]), pv


async def _run_jax_node(home, min_height):
    from cometbft_tpu.abci.kvstore import KVStoreApplication
    from cometbft_tpu.config import Config, test_consensus_config
    from cometbft_tpu.node import Node
    from cometbft_tpu.p2p import NodeKey

    doc, pv = _jax_doc_pv()
    cfg = Config(consensus=test_consensus_config())
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.rpc.laddr = ""
    cfg.base.signature_backend = "cpu"
    cfg.base.device_warmup = False
    cfg.instrumentation.watchdog_stall_threshold_s = 0.0
    node = await Node.create(doc, KVStoreApplication(), priv_validator=pv,
                             config=cfg,
                             node_key=NodeKey.from_secret(b"doctor-nk"),
                             home=home, name="drhome")
    await node.start()
    deadline = time.monotonic() + 60
    while node.height() < min_height:
        assert time.monotonic() < deadline
        await asyncio.sleep(0.02)
    h = node.height()
    await node.stop()
    return h


async def _run_port_node(home, extra_heights, with_status=False):
    """A port node on the (repaired) home: its doctor report, and the
    height it reaches ``extra_heights`` past where it opened."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.p2p import NodeKey
    from cometbft_tpu_torch.rpc import core

    from torch_node_fixtures import cpu_consensus_config

    doc, pv = _port_doc_pv()
    cfg = Config(consensus=cpu_consensus_config())
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = ""
    cfg.base.device = "cpu"
    node = await Node.create(doc, KVStoreApplication(device="cpu"),
                             priv_validator=pv, config=cfg,
                             node_key=NodeKey.from_secret(b"doctor-nk"),
                             home=home, name="drhome")
    try:
        start_h = node.height()
        await node.start()
        deadline = time.monotonic() + 90
        while node.height() < start_h + extra_heights:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.05)
        st = await core.status(core.Environment(node)) if with_status \
            else None
        return start_h, node.height(), node.doctor_report, st
    finally:
        await node.stop()


@pytest.fixture(scope="module")
def solo_home(tmp_path_factory):
    home = str(tmp_path_factory.mktemp("tdoctor") / "home")
    return home, run(_run_jax_node(home, 6))


def _stores(S, home):
    bs = S.BlockStore(S.open_db("logdb", os.path.join(home, "data",
                                                      "blockstore.db")))
    ss = S.StateStore(S.open_db("logdb", os.path.join(home, "data",
                                                      "state.db")))
    return bs, ss


def _close(bs, ss):
    bs.db.close()
    ss.db.close()


def _wal(home):
    return os.path.join(home, "data", "cs.wal")


def _pv_state(home):
    return os.path.join(home, "data", "pv_state.json")


# ---------------------------------------------------------------- damage

def _dmg_none(home, h):
    pass


def _dmg_state_behind(home, h):
    bs, ss = _stores(j_storage, home)
    j_doctor.StorageDoctor(bs, ss)._rebuild_state_at(
        j_doctor.DoctorReport(), ss.load(), h - 2, False)
    _close(bs, ss)


def _dmg_tip_lost(home, h):
    bs, ss = _stores(j_storage, home)
    bs.remove_tip()
    bs.remove_tip()
    _close(bs, ss)


def _dmg_pv(ahead, dirty=False):
    def damage(home, h):
        with open(_pv_state(home), "w") as f:
            json.dump({"height": h + ahead, "round": 0, "step": 3}, f)
        if dirty:
            bs, ss = _stores(j_storage, home)
            bs.db.mark_dirty()
            _close(bs, ss)
    return damage


def _dmg_block(offset, prune=0):
    def damage(home, h):
        bs, ss = _stores(j_storage, home)
        if prune:
            bs.prune_blocks(prune)
        bad = h - offset if offset else prune
        bs.db.set(height_key(K_BLOCK, bad), b"junk")
        _close(bs, ss)
    return damage


def _dmg_prune(retain):
    def damage(home, h):
        bs, ss = _stores(j_storage, home)
        bs.prune_blocks(retain)
        _close(bs, ss)
    return damage


def _dmg_stale_vals(home, h):
    from cometbft_tpu.types import codec
    from cometbft_tpu.types.priv_validator import MockPV
    from cometbft_tpu.types.validator_set import Validator, ValidatorSet

    bs, ss = _stores(j_storage, home)
    wrong = ValidatorSet([Validator(
        MockPV.from_secret(b"not-the-real-one").get_pub_key(), 10)])
    ss.db.set(height_key(K_VALS, h - 2), codec.pack(wrong))
    ss.db.mark_dirty()
    _close(bs, ss)


def _dmg_state_dirty(home, h):
    bs, ss = _stores(j_storage, home)
    ss.db.mark_dirty()
    _close(bs, ss)


def _dmg_salvage(home, h):
    """Flip a byte inside block h-2's record of the blockstore log: the
    next open salvages around it and marks the store dirty."""
    from cometbft_tpu.types import codec  # noqa: F401

    bs, ss = _stores(j_storage, home)
    raw_block = bs.db.get(height_key(K_BLOCK, h - 2))
    _close(bs, ss)
    path = os.path.join(home, "data", "blockstore.db")
    raw = bytearray(open(path, "rb").read())
    off = raw.rfind(raw_block[:64])
    assert off >= 0
    raw[off + 40] ^= 0x40
    open(path, "wb").write(bytes(raw))


# ---------------------------------------------------------------- checks

def _boot(**kw):
    def check(P, bs, ss, home):
        return P.doctor.StorageDoctor(
            bs, ss, wal_path=_wal(home),
            privval_state_path=_pv_state(home)).boot_check(**kw)
    return check


def _deep(**kw):
    def check(P, bs, ss, home):
        rep = P.doctor.DoctorReport()
        scan = P.doctor.StorageDoctor(bs, ss).deep_scan(report=rep, **kw)
        return scan, rep
    return check


def _anchor(P, bs, ss, home):
    """A statesync'd store (base == height, no blocks, the trusted seen
    commit) built from the home's records."""
    import tempfile

    state = ss.load()
    commit = bs.load_block_commit(bs.height() - 1)
    d = tempfile.mkdtemp(dir=os.path.dirname(home))
    S = P.storage
    bs2 = S.BlockStore(S.open_db("logdb", os.path.join(d, "blockstore.db")))
    ss2 = S.StateStore(S.open_db("logdb", os.path.join(d, "state.db")))
    ss2.bootstrap(dc_replace(state, last_block_height=commit.height))
    bs2.bootstrap_statesync(commit.height, commit)
    try:
        return P.doctor.StorageDoctor(bs2, ss2).boot_check(
            repair=True, force_deep=True)
    finally:
        _close(bs2, ss2)


CASES = {
    "consistent": (_dmg_none, _boot(repair=True)),
    "consistent_deep": (_dmg_none, _deep(window=0)),
    "blockstore_ahead": (_dmg_state_behind, _boot(repair=True)),
    "state_ahead_wal_quarantined": (_dmg_tip_lost, _boot(repair=True)),
    "privval_ahead_refuses": (_dmg_pv(50), _boot(repair=True)),
    "privval_ahead_report_only": (_dmg_pv(50), _boot(
        repair=False, raise_on_refusal=False)),
    "privval_ahead_dirty_store": (_dmg_pv(50, dirty=True),
                                  _boot(repair=True)),
    "privval_plus_one": (_dmg_pv(1), _boot(repair=True)),
    "deep_scan_truncates": (_dmg_block(3), _boot(repair=True,
                                                 force_deep=True)),
    "deep_scan_report_only": (_dmg_block(1), _deep(window=0,
                                                   repair=False)),
    "deep_scan_pruned_clamp": (_dmg_prune(3), _deep(window=100)),
    "deep_scan_above_pruned_base": (_dmg_block(1, prune=3),
                                    _deep(window=100, repair=True)),
    "deep_scan_at_pruned_base_refuses": (_dmg_block(0, prune=4),
                                         _deep(window=0, repair=True)),
    "statesync_anchor": (_dmg_none, _anchor),
    "stale_statestore_records": (_dmg_stale_vals, _boot(
        repair=True, raise_on_refusal=False)),
    "dirty_statestore_verifies": (_dmg_state_dirty, _boot(repair=True)),
    "salvaged_blockstore": (_dmg_salvage, _boot(repair=True)),
}

JAX = type("P", (), dict(doctor=j_doctor, storage=j_storage, wal=j_wal))
PORT = type("P", (), dict(doctor=t_doctor, storage=t_storage, wal=t_wal))


def _observe(P, home, check):
    bs, ss = _stores(P.storage, home)
    try:
        try:
            out = check(P, bs, ss, home)
        except P.doctor.DoctorError as e:
            out = ("refused", str(e), e.report.to_dict())
        if isinstance(out, P.doctor.DoctorReport):
            out = out.to_dict()
        elif isinstance(out, tuple) and len(out) == 2:
            out = (out[0], out[1].to_dict())
        state = ss.load()
        after = dict(height=bs.height(), base=bs.base(),
                     state=state.last_block_height if state else None,
                     bs_dirty=bs.is_dirty(), ss_dirty=ss.db.is_dirty(),
                     wal=sorted(n for n in os.listdir(
                         os.path.join(home, "data"))
                         if n.startswith("cs.wal")),
                     wal_end=P.wal.last_end_height(_wal(home)))
    finally:
        _close(bs, ss)
    return out, after


def _text(obs) -> str:
    """The observations as JSON, a decoder's own exception text cut
    (``msgpack.ExtraData`` against the port's ``ValueError``: the
    finding, its height and its place in the report stay)."""
    return re.sub(r"undecodable \((?:[^()]|\([^()]*\))*\)",
                  "undecodable (...)",
                  json.dumps(obs, sort_keys=True, default=repr))


@pytest.mark.parametrize("case", sorted(CASES))
def test_doctor_matches_jax_on_damaged_home(case, solo_home, tmp_path):
    src, h = solo_home
    damage, check = CASES[case]
    damaged = str(tmp_path / "damaged")
    shutil.copytree(src, damaged)
    damage(damaged, h)
    homes = {}
    for P, tag in ((JAX, "jax"), (PORT, "port")):
        homes[tag] = str(tmp_path / tag / "home")
        shutil.copytree(damaged, homes[tag])
    j = _observe(JAX, homes["jax"], check)
    t = _observe(PORT, homes["port"], check)
    assert _text(t) == _text(j)
    out, after = t
    if case == "state_ahead_wal_quarantined":
        assert after["state"] == after["height"] == h - 2
        assert any("quarantined" in a for a in out["actions"])
        assert after["wal_end"] is None
    if case == "privval_ahead_refuses":
        assert out[0] == "refused" and "double-sign" in out[1]
    if case == "deep_scan_truncates":
        assert out["deep_scan"]["bad"] == [h - 3]
        assert after["height"] == after["state"] == h - 4
    if case == "salvaged_blockstore":
        assert "blockstore" in out["salvage"] and not after["bs_dirty"]
    if case == "stale_statestore_records":
        assert out["refused"] and after["ss_dirty"]


@pytest.mark.parametrize("case", ["state_ahead_wal_quarantined",
                                  "salvaged_blockstore"])
def test_port_node_boots_repaired_home(case, solo_home, tmp_path):
    """The port node's own doctor repairs the damaged JAX-made home at
    ``Node.create``, reports it on ``/status``, and keeps committing."""
    src, h = solo_home
    damage, _ = CASES[case]
    home = str(tmp_path / "home")
    shutil.copytree(src, home)
    damage(home, h)
    start_h, end_h, report, st = run(_run_port_node(home, 2,
                                                    with_status=True))
    assert report is not None and report.ok and report.actions
    assert start_h < h and end_h >= start_h + 2
    assert st["doctor"] == report.to_dict()
    json.dumps(st["doctor"])
