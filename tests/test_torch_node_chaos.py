"""networks/chaos.toml's topology on port ``Node``s, cut small, on the
CPU over real loopback TCP: a seed (``p2p.seed_mode``) and 4
validators that dial only the seed and find each other through pex;
validator04's kvstore behind an ``ABCIServer`` (``base.abci =
"socket"``) and its key in a ``FilePV`` behind a signer that dials the
node's ``SignerListener``; delay-mode connection fuzzing on the
seed's and validator04's streams (delays of 0 s: each read and write
still yields to the loop through the fuzzer, and a loop pass here can
hold a plain-version check of up to 0.7 s, so fuzzing every node took
the case from 60 to 95 s, and 2 ms delays kept height 1 from
committing); to height 4.  Every app's recorded calls pass the ABCI grammar,
the remote app holds the committed tx, the remote signer signed the
node's votes, the books hold the peers learned through the seed, and
the seed hung up after harvesting.  The host oracle is patched to
raise (``torch_node_fixtures.no_host_verify``).

Discovery is driven in turn: each validator dials the seed (as the
node's starter does), takes the seed's answer, then runs
ensure-peers rounds (``PexReactor._ensure_peers``, the routine's tick)
until it holds every validator before it.  Here a handshake's device
checks take about a second of the plain versions (a handshake that
waits past its 8 s timeout behind them is dialled again on the next
round), and when ensure-peers rounds of several nodes overlap, two
nodes dial each other at once, each keeps the connection it registered
first and drops the other as a duplicate, and both go (the same race
in the JAX package); on the card it takes milliseconds, and the smoke's
phase 17 runs the periodic routine.

The links pex found are not persistent, and with the routine's ticks
off nothing dials them again: a link that drops leaves its validator
short of peers for the rest of the case.  The MConnection's 5 s pong
deadline (``p2p/conn.py:DEFAULT_PONG_TIMEOUT``) counts the seconds the
shared loop spends in plain checks, so under load (loop passes holding
checks for 2-4.5 s) a pong is read only after its deadline and the link
drops: with each check slowed by 0.6 s the case met its alarm in five
runs of seven, validator04 cut off from all three peers from height 2
on.  The nodes here wait 45 s for a pong (the reference's
``p2p.pong_timeout``)."""

import asyncio
import os

import pytest
import torch

from cometbft_tpu_torch.abci.grammar import RecordingApp
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.abci.server import ABCIServer
from cometbft_tpu_torch.libs import failures
from cometbft_tpu_torch.p2p import pex as ppex
from cometbft_tpu_torch.privval import FilePV, SignerListener, serve_dialer

from torch_node_fixtures import (agree, config, genesis,  # noqa: F401
                                 make_node, no_host_verify, run, stop_all,
                                 wait_height)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)

TOP = 4
PONG_TIMEOUT_S = 45.0


def test_seed_discovery_socket_app_remote_signer_under_fuzz(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(ppex, "CRAWL_LINGER", 1.0)
    failures.reset()

    async def main():
        doc, pvs = genesis(4, chain_id="chaos-net", tag=b"chaos")
        key = os.path.join(tmp_path, "key.json")
        state = os.path.join(tmp_path, "state.json")
        fpv = FilePV(pvs[3].priv_key, key, state)
        fpv.save_key()
        fpv._save_state()
        signed = []
        inner = fpv.sign_vote

        async def count_vote(chain_id, vote, sign_extension):
            await inner(chain_id, vote, sign_extension)
            signed.append((vote.height, vote.round, vote.type))

        fpv.sign_vote = count_vote
        listener = SignerListener(timeout_s=5.0)
        lhost, lport = await listener.listen()
        dialer = asyncio.create_task(serve_dialer(fpv, lhost, lport,
                                                  retry_interval=0.05))
        await listener.wait_for_signer(timeout=10)
        remote = RecordingApp(KVStoreApplication(device="cpu"))
        server = ABCIServer(remote, port=0)
        await server.start()

        def cfg(seed_mode=False, fuzz=False):
            c = config("memdb")
            c.p2p.seed_mode = seed_mode
            # the test runs the validators' ensure-peers rounds; the
            # seed crawls once, at start (its book empty then): periodic
            # redials of the seed would queue handshake checks behind
            # consensus's
            c.p2p.pex_interval_seconds = 3600.0
            c.p2p.test_fuzz = fuzz
            c.p2p.fuzz_mode = "delay"
            c.p2p.fuzz_max_delay_s = 0.0
            c.p2p.fuzz_start_after_s = 0.0
            c.p2p.fuzz_seed = 16
            return c

        seed = await make_node(doc, None, 0, "seed",
                               config_=cfg(True, fuzz=True))
        apps = [RecordingApp(KVStoreApplication(device="cpu"))
                for _ in range(3)]
        vcfg = cfg(fuzz=True)
        vcfg.base.abci = "socket"
        vcfg.base.proxy_app = f"127.0.0.1:{server.port}"
        vals = [await make_node(doc, pvs[i], i, "v", app=apps[i],
                                config_=cfg()) for i in range(3)]
        vals.append(await Node_create_remote(doc, listener, vcfg))
        nodes = [seed] + vals
        for n in nodes:
            n.switch.pong_timeout = PONG_TIMEOUT_S
        try:
            for n in nodes:
                await n.start(consensus=False)
            ids = {v.node_key.id for v in vals}
            for i, v in enumerate(vals):
                # the starter dials the seed; the seed answers the pex
                # request with the validators it met before
                await v.dial_peer(seed.listen_addr, persistent=False)
                earlier = {u.node_key.id for u in vals[:i]}

                async def learned(v=v):
                    while not earlier <= {j for j, _ in
                                          v.addr_book.sample(100)}:
                        await asyncio.sleep(0.02)

                async def dialled(v=v):
                    while not earlier <= set(v.switch.peers):
                        await asyncio.sleep(0.05)

                await asyncio.wait_for(learned(), 10)
                # ensure-peers rounds, as the routine ticks, until this
                # validator holds every one before it: a dial whose
                # handshake waited past its timeout behind the loop's
                # checks is dialled again on the next round
                for _ in range(8):
                    v.pex_reactor._ensure_peers()
                    try:
                        await asyncio.wait_for(dialled(), 10)
                        break
                    except asyncio.TimeoutError:
                        pass

            async def meshed():
                while not all(ids - {v.node_key.id} <= set(v.switch.peers)
                              for v in vals):
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(meshed(), 40)
            for v in vals:
                await v.start_consensus()
            await vals[0].mempool.check_tx(b"chaos=tx")
            await wait_height(vals, TOP, timeout=90)
        finally:
            await stop_all(nodes)
            await server.stop()
            await listener.close()
            dialer.cancel()
        agree(vals, TOP)
        for app in apps + [remote]:
            assert app.check() >= TOP
        q = await remote.inner.query("/key", b"chaos", 0, False)
        assert q.value == b"tx"
        assert any(h >= 1 for h, _, _ in signed)
        for v in vals:
            assert ids - {v.node_key.id} <= {
                i for i, _ in v.addr_book.sample(100)}
        assert not seed.switch.peers or all(
            p.outbound for p in seed.switch.peers.values())
        assert seed.addr_book.size() >= 4
        fc = vals[3].transport.fuzz_config
        assert fc.counts["delay"] > 0 and fc.counts["drop"] == 0

    run(main())


async def Node_create_remote(doc, listener, cfg):
    """validator04: the socket app at ``cfg.base.proxy_app`` and the
    remote signer's listener as its signer."""
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.p2p import NodeKey

    return await Node.create(doc, None, priv_validator=listener,
                             config=cfg, node_key=NodeKey.from_secret(b"v3"),
                             name="v3")
