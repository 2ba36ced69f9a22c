"""The port's networked node on the CPU, joining and restarting: a fourth
validator that connects after the others committed height 1 catches up
by vote gossip and joins consensus (``tests/test_node_network.py:150``);
a validator with a home directory (``LogDB`` stores, a WAL file and
``FilePV`` key and state files) is stopped mid-chain and restarted from
its home: the app handshake replays the stored blocks into a fresh app,
the WAL catches consensus up, the file signer's last-sign state guards
against a double sign, and every node agrees.  Helpers and timing
notes: ``tests/torch_node_fixtures.py``."""

import os

import pytest
import torch

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.privval import DoubleSignError, FilePV
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.vote import (PRECOMMIT_TYPE, PREVOTE_TYPE,
                                           Proposal, Vote)

from torch_node_fixtures import (agree, genesis, make_node, mesh,  # noqa: F401
                                 no_host_verify, run, start_meshed,
                                 stop_all, wait_height)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)


def test_node_joins_late_and_catches_up_votes():
    async def main():
        doc, pvs = genesis(4, tag=b"late")
        nodes = [await make_node(doc, pv, i, "tl") for i, pv in
                 enumerate(pvs)]
        started = []
        try:
            for n in nodes[:3]:
                await n.start()
                started.append(n)
            await mesh(nodes[:3])
            await wait_height(nodes[:3], 1)
            await nodes[3].start()
            started.append(nodes[3])
            for a in nodes[:3]:
                await nodes[3].dial_peer(a.listen_addr)
            target = max(n.height() for n in nodes[:3]) + 2
            await wait_height(nodes, target)
            agree(nodes, target)
        finally:
            await stop_all(started)
            for n in nodes[len(started):]:
                await n.stop()

    run(main())


def _file_pv(home, pv_secret_index):
    """A FilePV under ``home`` holding the key of ``genesis``'s
    validator (its key written to the JAX package's key-file layout)."""
    cfg_dir, data_dir = os.path.join(home, "config"), os.path.join(home,
                                                                  "data")
    kp = os.path.join(cfg_dir, "priv_validator_key.json")
    sp = os.path.join(data_dir, "priv_validator_state.json")
    if os.path.exists(kp):
        return FilePV.load(kp, sp)
    from cometbft_tpu_torch.types.priv_validator import MockPV

    mock = MockPV.from_secret(b"home%d" % pv_secret_index)
    pv = FilePV(mock.priv_key, kp, sp)
    pv.save_key()
    pv._save_state()
    return pv


async def _assert_refuses_conflict(pv):
    """A message for the signer's last height, round and step that
    differs from what it signed is refused."""
    bid = BlockID(b"\x42" * 32, PartSetHeader(1, b"\x43" * 32))
    if pv.step == 1:
        with pytest.raises(DoubleSignError):
            await pv.sign_proposal("home-net", Proposal(
                height=pv.height, round=pv.round, pol_round=-1,
                block_id=bid, timestamp_ns=1))
        return
    typ = PREVOTE_TYPE if pv.step == 2 else PRECOMMIT_TYPE
    with pytest.raises(DoubleSignError):
        await pv.sign_vote("home-net", Vote(
            type=typ, height=pv.height, round=pv.round, block_id=bid,
            timestamp_ns=1, validator_address=pv.get_pub_key().address(),
            validator_index=0), False)


def test_restart_from_home(tmp_path):
    async def main():
        homes = [str(tmp_path / f"v{i}") for i in range(4)]
        pvs = [_file_pv(h, i) for i, h in enumerate(homes)]
        doc = GenesisDoc(chain_id="home-net", validators=[
            GenesisValidator(pv.get_pub_key(), 10) for pv in pvs])
        nodes = [await make_node(doc, pv, i, "th", home=homes[i])
                 for i, pv in enumerate(pvs)]
        live = list(nodes)
        try:
            await start_meshed(nodes)
            await wait_height(nodes, 2)
            victim = nodes[2]
            await victim.stop()
            live.remove(victim)
            stopped_at = victim.height()
            await wait_height(live, stopped_at + 1)
            # restart from the home: LogDB stores, WAL, FilePV files
            pv = _file_pv(homes[2], 2)
            assert pv.height >= 2
            back = await make_node(doc, pv, 2, "th", home=homes[2],
                                   app=KVStoreApplication(device="cpu"))
            assert back.height() == stopped_at
            # the handshake replayed the stored blocks into the new app
            info = await back.app_conns.query.info()
            assert info.last_block_height == stopped_at
            await back.start()
            live.append(back)
            for other in nodes[:2] + nodes[3:]:
                await back.dial_peer(other.listen_addr)
            target = max(n.height() for n in live) + 1
            await wait_height(live, target)
            agree(live, target)
            # the file signer refuses to sign anything conflicting with
            # its persisted last-sign state
            await _assert_refuses_conflict(pv)
        finally:
            await stop_all(live)

    run(main())
