"""Randomized testnet manifest generator (counterpart of
``cometbft_tpu/e2e/generator.py``; reference:
``test/e2e/generator/generator.go``): a seed deterministically expands
into a manifest sweeping the configuration axes — database backend, ABCI
transport, key types, node roles, late starts, perturbations, validator
updates, latency emulation — so permutation coverage finds integration
bugs hand-written manifests never exercise.

Determinism contract: ``generate_manifest(seed)`` depends only on the
seed (its own ``random.Random``), so a CI failure reproduces from the
seed alone.
"""

from __future__ import annotations

import random

from .manifest import LoadManifest, Manifest, NodeManifest


def _weighted(rng: random.Random, choices: dict):
    """One key of ``choices`` picked by weight."""
    total = sum(choices.values())
    x = rng.uniform(0, total)
    for k, w in choices.items():
        x -= w
        if x <= 0:
            return k
    return k


def generate_manifest(seed: int, *, compact: bool = False) -> Manifest:
    """Deterministic manifest for ``seed``.

    ``compact`` bounds the topology for CI (<= 4 backing nodes, short
    chain); without it, up to 4 validators + 2 full nodes + seed +
    light client.
    """
    rng = random.Random(seed)
    m = Manifest()
    m.chain_id = f"gen-{seed}"
    m.final_height = 8 if compact else rng.choice([10, 12, 15])

    n_validators = rng.randint(2, 3 if compact else 4)
    n_full = rng.randint(0, 1 if compact else 2)
    with_seed_node = (not compact) and rng.random() < 0.3
    with_light = rng.random() < (0.3 if compact else 0.5)

    databases = {"logdb": 3, "native": 2, "memdb": 1}
    abcis = {"builtin": 3, "socket": 2, "grpc": 1}
    key_types = {"ed25519": 4, "secp256k1": 1}

    names: list[str] = []
    for i in range(n_validators):
        name = f"validator{i + 1:02d}"
        node = NodeManifest(name=name, mode="validator")
        node.database = _weighted(rng, databases)
        node.abci_protocol = _weighted(rng, abcis)
        node.key_type = _weighted(rng, key_types)
        m.nodes[name] = node
        m.validators[name] = rng.choice([10, 20, 50, 100])
        names.append(name)

    for i in range(n_full):
        name = f"full{i + 1:02d}"
        node = NodeManifest(name=name, mode="full")
        node.database = _weighted(rng, databases)
        node.abci_protocol = _weighted(rng, abcis)
        if rng.random() < 0.7:
            node.start_at = rng.randint(2, max(2, m.final_height // 2))
        m.nodes[name] = node
        names.append(name)

    if with_seed_node:
        m.nodes["seed01"] = NodeManifest(name="seed01", mode="seed")

    if with_light:
        m.nodes["light01"] = NodeManifest(
            name="light01", mode="light",
            start_at=rng.randint(2, max(2, m.final_height // 2)))

    # perturbations: only on validators the chain can spare (keep > 2/3
    # of voting power un-perturbed so liveness never depends on the
    # recovery action firing promptly), never on memdb nodes
    perturbable = [n for n in names
                   if m.nodes[n].mode == "validator"
                   and m.nodes[n].database != "memdb"]
    total_power = sum(m.validators.values())
    budget = total_power - (total_power * 2 // 3 + 1)
    rng.shuffle(perturbable)
    for name in perturbable:
        if m.validators[name] > budget or rng.random() > 0.5:
            continue
        budget -= m.validators[name]
        h = rng.randint(3, max(3, m.final_height - 4))
        kind = rng.choice(["kill", "pause"])
        recover = {"kill": "restart", "pause": "resume"}[kind]
        m.nodes[name].perturb = [f"{kind}:{h}", f"{recover}:{h + 2}"]

    # a validator-power update mid-chain (ed25519 targets only — the
    # kvstore valset tx carries ed25519 keys)
    ed_vals = [n for n in m.validators
               if m.nodes[n].key_type == "ed25519"
               and not m.nodes[n].perturb]
    if ed_vals and rng.random() < 0.5:
        target = rng.choice(ed_vals)
        h = rng.randint(3, max(3, m.final_height - 3))
        m.validator_updates[h] = {
            target: m.validators[target] + rng.choice([10, 25])}

    if rng.random() < 0.3:
        m.emulated_latency_ms = rng.choice([20.0, 50.0])
    if (not compact) and rng.random() < 0.2:
        m.fuzz = True

    m.load = LoadManifest(rate=rng.choice([5.0, 10.0, 20.0]),
                          duration=10.0 if compact else 20.0,
                          size=rng.choice([32, 64, 256]))
    m.validate()
    return m
