"""The statesync lab on the port, on the CPU
(``tests/test_statesync_fabric.py``'s fleet cases):
``curated_statesync_scenario(small=True)`` (4 validators, 3 seeds, 4
bootstrappers, one seed serving corrupt chunks) through the port with
``device="cpu"``, its verdict equal to the JAX package's and
replay-identical.  A run is about 300 one-lane checks of the plain
versions (the chain runs on while the fleet syncs), so the port's first
run is a module fixture both cases read.  The 50-node program is the
``slow`` twin, as in the JAX package's file; it runs on the card in
``chip_smoke.py``'s phase 19."""

import pytest
import torch

from cometbft_tpu.sim import statesync_lab as jlab
from cometbft_tpu_torch.sim import statesync_lab as tlab

from torch_node_fixtures import no_host_verify  # noqa: F401
from torch_sim_fixtures import _first_difference, canon

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(180)


@pytest.fixture(scope="module")
def small_run():
    scn = tlab.curated_statesync_scenario(small=True)
    return scn, tlab.run_statesync_scenario(scn, device="cpu")


def test_small_fleet_verdict_equals_jax(small_run):
    scn, v = small_run
    jv = jlab.run_statesync_scenario(
        jlab.StatesyncScenario.from_dict(scn.to_dict()))
    assert canon(v) == canon(jv), _first_difference(jv, v)


def test_small_fleet_scenario_replay_identical(small_run):
    scn, v1 = small_run
    v2 = tlab.run_statesync_scenario(scn, device="cpu")
    assert v1 == v2, "verdict must be a pure function of (scenario, seed)"
    assert v1["completed"] == scn.n_bootstrappers, v1["failed"]
    assert v1["restored_state_matches_chain"]
    t = v1["syncer_tallies"]
    assert t["chunk_hash_mismatches"] >= 1     # byzantine seed caught
    assert t["restore_resets"] == 0            # ...without a reset
    assert len(v1["byzantine_banned_by"]) == scn.n_bootstrappers
    assert v1["chaos"]["sites"].get("statesync.serve.corrupt", 0) >= 1
    rt = tlab.StatesyncScenario.from_dict(scn.to_dict())
    assert rt.to_dict() == scn.to_dict()


@pytest.mark.slow
@pytest.mark.timeout(900)
def test_fleet_50_node_bootstrap_scenario():
    """The 50-node program: 40 bootstrappers, 4 seeds, gray failures,
    one byzantine seed; every bootstrapper completes, the byzantine seed
    is banned fleet-wide, no restore reset, and the verdict is the JAX
    package's."""
    scn = tlab.curated_statesync_scenario()
    v = tlab.run_statesync_scenario(scn, device="cpu")
    jv = jlab.run_statesync_scenario(scn_j := jlab.curated_statesync_scenario())
    assert scn_j.to_dict() == scn.to_dict()
    assert canon(v) == canon(jv), _first_difference(jv, v)
    assert v["completed"] == scn.n_bootstrappers, v["failed"]
    assert v["restored_state_matches_chain"]
    assert v["syncer_tallies"]["restore_resets"] == 0
    assert len(v["byzantine_banned_by"]) == scn.n_bootstrappers
    d = v["time_to_serving_height_s"]
    assert d["min"] is not None and d["max"] is not None
    assert d["min"] <= d["p50"] <= d["p90"] <= d["max"]
