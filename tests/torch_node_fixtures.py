"""Shared helpers of the port's networked-node tests
(``tests/test_torch_node*.py``): port ``Node``s on ``device="cpu"``,
each with its own loopback listener on port 0 (nothing binds a fixed
port, so parallel test workers never collide), full mesh over TCP, the
host oracle patched to raise.  A one-lane check of the plain versions
takes 0.3-0.7 s here, on the event loop's thread for a vote-set miss or
a proposal; a 4-validator height needs 12 of them (8 own votes, 4
proposals; a precommit and its vote extension are one check) plus two a
connection at the handshake (1.1 s a connection), so heights take
seconds and a vote-extension network reaches height 4 in about 40 s.
The loop stands still during a check, so the
JAX package's test timeouts (80 ms to propose) would expire before
peers' messages are handled and every height would run several rounds:
:func:`cpu_consensus_config` keeps its commit timeout but waits 2 s to
propose and 1 s for prevotes and precommits (the reference's defaults
are 3 s and 1 s).  Dials run one after another: concurrent handshakes
queue their device checks behind each other past the handshake
timeout.  :func:`start_meshed` meshes the nodes before their consensus
starts: a running node's checks hold the shared loop for seconds at a
time (19 of a 22 s mesh with vote extensions on), and a handshake then
waits past its 8 s timeout for the peer's node info."""

import asyncio

import pytest

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import MS, Config, test_consensus_config
from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto import scheduler as vsched
from cometbft_tpu_torch.node import Node
from cometbft_tpu_torch.p2p import NodeKey
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.priv_validator import MockPV


def run(coro):
    """``coro`` on a new event loop.  Where it does not finish (a failure
    in another task, or the per-case alarm's ``SystemExit`` raised
    wherever the loop was), the case's own ``finally`` still runs: the
    coroutine is cancelled and the loop runs on while it stops its
    nodes, servers and sockets; then every task left is cancelled.  So a
    failure is reported once, by the case, and nothing it opened stays
    open for the worker's next case."""
    loop = asyncio.new_event_loop()
    main = loop.create_task(coro)
    try:
        return loop.run_until_complete(main)
    except BaseException:
        _unwind(loop, main)
        raise
    finally:
        loop.close()


def _unwind(loop, main):
    _cancel(loop, [main])
    _cancel(loop, [t for t in asyncio.all_tasks(loop) if not t.done()])


def _cancel(loop, tasks, timeout=60.0):
    for t in tasks:
        t.cancel()
    if tasks:
        try:
            loop.run_until_complete(asyncio.wait(tasks, timeout=timeout))
        except BaseException:
            pass          # the failure reported is the one that unwound


@pytest.fixture(autouse=True)
def no_host_verify(monkeypatch):
    """Every check of the port's node runs on the device (the plain
    versions here); no scheduler outlives a case."""
    def refuse(*a, **kw):
        raise AssertionError("host oracle called on the node path")

    monkeypatch.setattr(ref, "verify_zip215", refuse)
    vsched.set_scheduler(None)
    yield
    assert vsched.get_scheduler() is None, "a node kept the scheduler"
    vsched.set_scheduler(None)


def genesis(n: int, chain_id="tcp-net", tag=b"tcpnode", ext_height=0):
    pvs = [MockPV.from_secret(tag + b"%d" % i) for i in range(n)]
    doc = GenesisDoc(chain_id=chain_id,
                     validators=[GenesisValidator(pv.get_pub_key(), 10)
                                 for pv in pvs])
    doc.consensus_params.feature.vote_extensions_enable_height = ext_height
    return doc, pvs


def cpu_consensus_config():
    cc = test_consensus_config()
    cc.timeout_propose = 2000 * MS
    cc.timeout_prevote = 1000 * MS
    cc.timeout_precommit = 1000 * MS
    return cc


def config(db_backend="logdb") -> Config:
    cfg = Config(consensus=cpu_consensus_config())
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = ""              # no RPC server unless a case asks
    cfg.base.device = "cpu"
    cfg.storage.db_backend = db_backend
    return cfg


async def make_node(doc, pv, i, tag="n", home=None, app=None,
                    config_=None, **kw):
    return await Node.create(
        doc, app or KVStoreApplication(device="cpu"), priv_validator=pv,
        config=config_ or config(), node_key=NodeKey.from_secret(b"%s%d" % (
            tag.encode(), i)), home=home, name=f"{tag}{i}", **kw)


async def mesh(nodes):
    """Full mesh: i dials j for i < j (persistent)."""
    for i, a in enumerate(nodes):
        for b in nodes[i + 1:]:
            await a.dial_peer(b.listen_addr, persistent=True)


async def start_meshed(nodes):
    """Start the nodes' listeners and reactors, mesh them, then start
    their consensus."""
    for n in nodes:
        await n.start(consensus=False)
    await mesh(nodes)
    for n in nodes:
        await n.start_consensus()


async def wait_height(nodes, h, timeout=100.0):
    async def all_reached():
        while not all(n.height() >= h for n in nodes):
            await asyncio.sleep(0.05)

    await asyncio.wait_for(all_reached(), timeout)


def agree(nodes, top):
    for h in range(1, top + 1):
        hashes = {n.block_store.load_block(h).hash() for n in nodes}
        assert len(hashes) == 1, f"fork at height {h}"


async def stop_all(nodes):
    for n in nodes:
        await n.stop()
