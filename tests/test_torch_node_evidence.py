"""The port's networked node under a byzantine validator, on the CPU
over real loopback TCP (``tests/test_evidence_network.py:37`` on port
nodes): a double-signed precommit rides the live vote gossip, becomes
duplicate-vote evidence (both votes checked on the device), reaches
every app as ABCI misbehaviour, and the evidence reactor gossips a
pool's evidence to a peer's pool.  Helpers and timing notes:
``tests/torch_node_fixtures.py``."""

import asyncio

import pytest
import torch

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence
from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE, Vote

from torch_node_fixtures import (genesis, make_node,  # noqa: F401
                                 no_host_verify, run, start_meshed,
                                 stop_all, wait_height)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)


async def _all_apps_saw_misbehavior(apps, byz_addr):
    while True:
        hits = sum(1 for app in apps if any(
            mb.validator_address == byz_addr and mb.type == "DUPLICATE_VOTE"
            for mb in app.misbehavior_seen))
        if hits == len(apps):
            return
        await asyncio.sleep(0.05)


def test_double_sign_detected_and_gossiped_over_tcp():
    async def main():
        doc, pvs = genesis(4, chain_id="ev-net", tag=b"evnet")
        apps = [KVStoreApplication(device="cpu") for _ in range(4)]
        nodes = [await make_node(doc, pv, i, "ev", app=apps[i])
                 for i, pv in enumerate(pvs)]
        try:
            await start_meshed(nodes)
            byz = nodes[3]
            byz_addr = pvs[3].get_pub_key().address()
            byz_idx, _ = byz.consensus.state.validators.get_by_address(
                byz_addr)
            # one equivocation at the byzantine node's height and round,
            # sent again only if it missed that height (every extra one
            # is more evidence, each costing every node two device lanes)
            for _ in range(3):
                rs = byz.consensus.rs
                fake = Vote(type=PRECOMMIT_TYPE, height=rs.height,
                            round=rs.round,
                            block_id=BlockID(b"\x55" * 32,
                                             PartSetHeader(1, b"\x44" * 32)),
                            timestamp_ns=424242, validator_address=byz_addr,
                            validator_index=byz_idx)
                await pvs[3].sign_vote("ev-net", fake, sign_extension=False)
                byz.consensus_reactor._broadcast_vote(fake)
                try:
                    await asyncio.wait_for(
                        _all_apps_saw_misbehavior(apps, byz_addr), 35)
                    break
                except asyncio.TimeoutError:
                    continue
            else:
                raise AssertionError("misbehavior never reached the apps")

            # evidence-channel gossip alone: fresh evidence for a
            # committed height, added to node0's pool only
            await wait_height(nodes, 1)
            h2 = min(n.height() for n in nodes)
            vals = nodes[0].consensus.state.validators
            votes = []
            for tag in (b"\x11", b"\x33"):
                v = Vote(type=PRECOMMIT_TYPE, height=h2, round=0,
                         block_id=BlockID(tag * 32,
                                          PartSetHeader(1, tag * 32)),
                         timestamp_ns=7, validator_address=byz_addr,
                         validator_index=byz_idx)
                await pvs[3].sign_vote("ev-net", v, sign_extension=False)
                votes.append(v)
            ev2 = DuplicateVoteEvidence.from_votes(
                votes[0], votes[1],
                nodes[0].consensus.state.last_block_time_ns, vals)
            assert nodes[0].evidence_pool.add_evidence(ev2)
            deadline = asyncio.get_running_loop().time() + 30
            while not nodes[1].evidence_pool.is_pending(ev2) and \
                    not nodes[1].evidence_pool.is_committed(ev2):
                assert asyncio.get_running_loop().time() < deadline, \
                    "evidence never gossiped pool-to-pool"
                await asyncio.sleep(0.05)
        finally:
            await stop_all(nodes)

    run(main())
