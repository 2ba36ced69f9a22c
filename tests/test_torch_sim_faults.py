"""The scenario lab's network faults on the port, on the CPU
(``tests/test_sim.py``'s and ``tests/test_fuzz.py``'s cases): a
partition healed, a crash with a wiped restart, and 3% packet drops.
Each scenario runs through the JAX package and through the port with
``device="cpu"``; the port's verdict JSON and fault signature must equal
the JAX package's, then the JAX tests' own checks hold on the port's
verdict.  The host oracle is patched to raise."""

import pytest
import torch

from cometbft_tpu_torch.libs import clock, failures

from torch_node_fixtures import no_host_verify  # noqa: F401
from torch_sim_fixtures import both

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(150)


def test_partition_heal_liveness_and_recovery_metric():
    v, _ = both("t-partition")
    assert v["reached_target"] and v["fork_free"]
    assert v["common_height"] >= 5
    assert v["time_to_recover_s"] is not None
    assert len(v["block_hashes"]) == v["common_height"]


def test_crash_restore_rejoins():
    """The restored node is back in the honest floor: reaching the
    target proves the wiped rejoin."""
    v, _ = both("t-crash")
    assert v["reached_target"] and v["fork_free"]
    assert v["common_height"] >= 5


def test_network_commits_under_connection_fuzzing():
    """4 nodes with the fault plane dropping about 3% of wire packets
    (reassembly holes: real teardowns and reconnects) reach height 4
    within 150 virtual seconds."""
    v, _ = both("fuzz-drop-net")
    assert v["reached_target"], \
        f"stuck at height {v['common_height']} under 3% packet drop"
    assert v["fork_free"]
    assert v["chaos"]["sites"].get("p2p.send.drop", 0) > 0
    assert clock.installed() is None
    assert failures.stats() == {"enabled": False}
