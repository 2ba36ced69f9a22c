"""The scenario lab's byzantine adversaries on the port, on the CPU
(``tests/test_sim.py``'s and ``tests/test_mempool.py``'s cases): the
equivocator, the flooder and the tx flood into a tiny pool.  Each
scenario runs through the JAX package and through the port with
``device="cpu"``; the port's verdict JSON and fault signature must equal
the JAX package's, then the JAX tests' own checks hold on the port's
verdict.  The host oracle is patched to raise."""

import pytest
import torch

from torch_node_fixtures import no_host_verify  # noqa: F401
from torch_sim_fixtures import both

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(150)


def test_double_sign_scenario_ends_in_committed_evidence():
    """The equivocator's conflicting votes flow through the evidence
    pool into a committed block, the byzantine validator is named, and
    no honest node is banned for relaying the evidence."""
    v, _ = both("t-equivocator")
    assert v["fork_free"], "one equivocator must not fork 3f+1 honest"
    assert v["reached_target"]
    assert v["evidence"]["committed_total"] >= 1
    assert v["evidence"]["byzantine_punished"] == ["sim002"]
    assert "bad_evidence" not in v["misbehavior_events"]
    assert "bad_evidence" not in v["bans"]["by_reason"]
    for name in v["bans"]["banned_nodes"]:
        assert name == "sim002", f"honest node {name} banned"


def test_flooder_is_banned_and_net_survives():
    v, _ = both("t-flood")
    assert v["reached_target"] and v["fork_free"]
    assert v["misbehavior_events"].get("invalid_tx", 0) > 0
    assert v["bans"]["total"] >= 1
    assert v["bans"]["banned_nodes"] == ["sim004"]


def test_txflood_scenario_sheds_and_bans():
    """The tx-flood adversary into pools of 8: the flooder is scored
    and banned, victims shed (full-pool skips) and the announce/fetch
    path runs, fork-free (``tests/test_mempool.py``'s scenario)."""
    v, _ = both("t-txflood-shed")
    assert v["reached_target"] and v["fork_free"]
    assert v["misbehavior_events"].get("invalid_tx", 0) > 0
    assert v["bans"]["banned_nodes"] == ["sim004"]
    mp = v["mempool"]
    assert mp["full_skips"] > 0, "tiny pool never shed the flood"
    assert mp["fetch_requests"] > 0 and mp["fetch_fulfilled"] > 0
