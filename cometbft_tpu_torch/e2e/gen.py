"""Testnet home generation (counterpart of ``cometbft_tpu/e2e/gen.py``;
reference: ``cmd/cometbft/commands/testnet.go`` and ``test/e2e/runner/
setup.go``): one place that lays out node homes (keys, a shared genesis,
wired configs) for both the ``testnet`` command and the e2e runner."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass


@dataclass
class HomeSpec:
    name: str
    p2p_port: int
    rpc_port: int
    power: int | None = None          # None -> not a genesis validator
    key_type: str = "ed25519"


def generate_homes(base_dir: str, specs: list[HomeSpec], chain_id: str,
                   *, initial_height: int = 1,
                   persistent_peers=None, tweak=None) -> None:
    """Create a home per spec with a shared genesis.

    ``persistent_peers(spec) -> str`` supplies each node's peer list
    (default: all other nodes).  ``tweak(spec, cfg)`` mutates each
    config before save."""
    from ..config import Config
    from ..p2p import NodeKey
    from ..privval import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator

    pvs = {}
    for spec in specs:
        home = os.path.join(base_dir, spec.name)
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        cfg = Config()
        NodeKey.load_or_gen(os.path.join(home, cfg.base.node_key_file))
        pvs[spec.name] = FilePV.load_or_generate(
            os.path.join(home, cfg.base.priv_validator_key_file),
            os.path.join(home, cfg.base.priv_validator_state_file),
            key_type=spec.key_type)

    doc = GenesisDoc(
        chain_id=chain_id,
        genesis_time_ns=time.time_ns(),
        initial_height=initial_height,
        validators=[GenesisValidator(pvs[s.name].get_pub_key(),
                                     s.power, s.name,
                                     pop=pvs[s.name].pop())
                    for s in specs if s.power is not None])

    for spec in specs:
        home = os.path.join(base_dir, spec.name)
        cfg = Config()
        cfg.base.moniker = spec.name
        cfg.p2p.laddr = f"tcp://127.0.0.1:{spec.p2p_port}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{spec.rpc_port}"
        if persistent_peers is not None:
            cfg.p2p.persistent_peers = persistent_peers(spec)
        else:
            cfg.p2p.persistent_peers = ",".join(
                f"tcp://127.0.0.1:{o.p2p_port}"
                for o in specs if o.name != spec.name)
        if tweak is not None:
            tweak(spec, cfg)
        cfg.save(os.path.join(home, "config", "config.toml"))
        doc.save(os.path.join(home, cfg.base.genesis_file))
