"""The scenario lab's reference verdicts, and the small scenarios the
port's sim tests share.

``tests/torch_sim_reference.json`` holds, for each scenario of the JAX
package's ``curated_suite()`` and for both programs of
``curated_statesync_scenario`` (``small=False`` and ``small=True``), the
scenario's dict, the JAX package's verdict on the CPU and the fault
plane's signature (its length for the statesync programs, whose entry
point returns none).  Every field of a verdict is a pure function of the
scenario and its seed, so the file is the reference that the port's
verdicts are held to: on the CPU by ``tests/test_torch_sim_reference.py``
and on the card by ``chip_smoke.py``'s phase 19, which reads the file and
imports nothing of the JAX package.

Rewrite it from the JAX package (about two and a half minutes of CPU,
megamix-100 most of it)::

    python tests/torch_sim_fixtures.py --write
"""

import json
import os
import platform
import sys

REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_sim_reference.json")

# tests/test_sim.py's and tests/test_fuzz.py's and tests/test_mempool.py's
# scenarios, as dicts (Scenario.from_dict loads them in either package)
SMALL = {
    "t-partition": {
        "name": "t-partition", "seed": 21, "n_nodes": 7, "out_links": 3,
        "target_height": 5, "max_virtual_s": 900.0,
        "steps": [{"at": 0.3, "op": "partition",
                   "groups": [[0, 1], [2, 3, 4, 5, 6]]},
                  {"at": 1.5, "op": "heal"}]},
    "t-replay": {
        "name": "t-replay", "seed": 99, "n_nodes": 5, "out_links": 2,
        "target_height": 3,
        "faults": ["p2p.recv.corrupt:prob=0.05:max=8",
                   "p2p.send.delay:every=40:delay=0.05:max=10"]},
    "t-equivocator": {
        "name": "t-equivocator", "seed": 31, "n_nodes": 5, "out_links": 2,
        "target_height": 6, "max_virtual_s": 900.0,
        "byzantine": {"2": "equivocator"}},
    "t-flood": {
        "name": "t-flood", "seed": 41, "n_nodes": 5, "out_links": 2,
        "target_height": 8, "max_virtual_s": 900.0,
        "byzantine": {"4": "flooder"}, "tuning": {"ban_ttl_s": 2.0}},
    "t-crash": {
        "name": "t-crash", "seed": 51, "n_nodes": 5, "out_links": 2,
        "target_height": 5, "max_virtual_s": 900.0,
        "steps": [{"at": 0.8, "op": "crash", "node": 1},
                  {"at": 2.0, "op": "restore", "node": 1}]},
    "fuzz-drop-net": {
        "name": "fuzz-drop-net", "seed": 20260730, "n_nodes": 4,
        "out_links": 2, "target_height": 4, "max_virtual_s": 150.0,
        "faults": ["p2p.send.drop:prob=0.03"]},
    "t-txflood-shed": {
        "name": "t-txflood-shed", "seed": 61, "n_nodes": 5, "out_links": 2,
        "target_height": 8, "max_virtual_s": 900.0,
        "byzantine": {"4": "flooder"},
        "tuning": {"ban_ttl_s": 2.0, "mempool_size": 8,
                   "mempool_gossip_sleep": 0.1}},
}


def scenario(pkg, name):
    """SMALL[name] as ``pkg``'s Scenario (``pkg`` is either package's
    ``sim.scenario`` module; a partial tuning dict takes the defaults
    for the rest)."""
    return pkg.Scenario.from_dict(SMALL[name])


def canon(v) -> str:
    """A verdict as the JSON both packages' tests compare."""
    return json.dumps(v, sort_keys=True)


def both(name):
    """SMALL[name] run by the JAX package on the CPU and by the port with
    ``device="cpu"``: the port's verdict and fault signature, after
    checking that they equal the JAX package's."""
    from cometbft_tpu.sim import scenario as JS

    from cometbft_tpu_torch.sim import scenario as TS

    jv, jsig = JS.chaos_signature_of(scenario(JS, name))
    tv, tsig = TS.chaos_signature_of(scenario(TS, name), device="cpu")
    assert canon(tv) == canon(jv), _first_difference(jv, tv)
    assert tsig == jsig
    return tv, tsig


def _first_difference(a, b, path="verdict"):
    """Where two JSON values first differ, for an assertion message."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b or a[k] != b[k]:
                return _first_difference(a.get(k), b.get(k), f"{path}.{k}")
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_difference(x, y, f"{path}[{i}]")
    return f"{path}: JAX {a!r} != port {b!r}"


def jax_entry(name=None, statesync=None) -> dict:
    """One reference entry from the JAX package on the CPU: a curated
    scenario by ``name``, or a statesync program by ``statesync`` (its
    ``small`` flag)."""
    if statesync is None:
        from cometbft_tpu.sim import scenario as S

        scn = next(s for s in S.curated_suite() if s.name == name)
        verdict, sig = S.chaos_signature_of(scn)
        return {"dict": scn.to_dict(), "verdict": verdict,
                "signature": [list(x) for x in sig],
                "signature_len": len(sig)}
    from cometbft_tpu.sim import statesync_lab as L

    scn = L.curated_statesync_scenario(small=statesync)
    verdict = L.run_statesync_scenario(scn)
    return {"dict": scn.to_dict(), "small": statesync, "verdict": verdict,
            "signature_len": verdict["chaos"]["signature_len"]}


def load_reference() -> dict:
    with open(REFERENCE) as f:
        return json.load(f)


def write_reference() -> dict:
    from cometbft_tpu.sim import scenario as S

    ref = {"written_by": "python tests/torch_sim_fixtures.py --write",
           "python": platform.python_version(),
           "scenarios": [jax_entry(s.name) for s in S.curated_suite()],
           "statesync": [jax_entry(statesync=small)
                         for small in (False, True)]}
    with open(REFERENCE, "w") as f:
        json.dump(ref, f, indent=1, sort_keys=True)
        f.write("\n")
    return ref


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/torch_sim_fixtures.py --write")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = write_reference()
    print(f"wrote {REFERENCE}: {len(out['scenarios'])} scenarios, "
          f"{len(out['statesync'])} statesync programs")
