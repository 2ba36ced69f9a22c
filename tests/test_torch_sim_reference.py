"""The reference file is honest (``tests/torch_sim_reference.json``,
written by ``python tests/torch_sim_fixtures.py --write``): its dicts are
both packages' ``curated_suite()`` and ``curated_statesync_scenario``
programs, and the JAX package, run here again, gives the file's verdict
and fault signature for crash-restore-16 and partition-heal-25.  The
port's verdicts of the whole file are held on the card by
``chip_smoke.py --sim``; here a curated run of the port would take an
hour of plain-version checks."""

import pytest

from cometbft_tpu.sim import scenario as jscenario
from cometbft_tpu.sim import statesync_lab as jlab
from cometbft_tpu_torch.sim import scenario as tscenario
from cometbft_tpu_torch.sim import statesync_lab as tlab

from torch_sim_fixtures import canon, jax_entry, load_reference

pytestmark = pytest.mark.timeout(120)


def test_reference_dicts_are_both_packages_suites():
    ref = load_reference()
    dicts = [e["dict"] for e in ref["scenarios"]]
    assert dicts == [s.to_dict() for s in jscenario.curated_suite()]
    assert dicts == [s.to_dict() for s in tscenario.curated_suite()]
    for e in ref["statesync"]:
        small = e["small"]
        assert e["dict"] == jlab.curated_statesync_scenario(small).to_dict()
        assert e["dict"] == tlab.curated_statesync_scenario(small).to_dict()
        assert tlab.StatesyncScenario.from_dict(e["dict"]).to_dict() == \
            e["dict"]
    for e in ref["scenarios"]:
        assert tscenario.Scenario.from_dict(e["dict"]).to_dict() == \
            e["dict"]
        assert e["signature_len"] == len(e["signature"]) == \
            e["verdict"]["chaos"]["signature_len"]
        assert e["verdict"]["reached_target"] and e["verdict"]["fork_free"]


@pytest.mark.parametrize("name", ["crash-restore-16", "partition-heal-25"])
def test_reference_verdict_recomputes(name):
    entry = next(e for e in load_reference()["scenarios"]
                 if e["dict"]["name"] == name)
    fresh = jax_entry(name)
    assert canon(fresh["verdict"]) == canon(entry["verdict"])
    assert fresh["signature"] == entry["signature"]
