"""Deterministic scenario lab (counterpart of ``cometbft_tpu/sim``): a
virtual-time clock, an in-memory transport and seeded byzantine
adversaries; hundreds of in-process nodes, replayable from a seed, each
run's verdict equal to the JAX package's.

Never imported by a node: the real-time path pays nothing for the lab
(the ``libs/clock`` seam short-circuits to ``time``/``asyncio`` when no
virtual clock is installed)."""

from .node import SimNode, SimTuning, make_genesis, make_sim_node
from .scenario import Scenario, curated_suite, run_scenario
from .transport import LinkPolicy, MemConn, MemNetwork, MemTransport
from .vtime import (VirtualClock, VirtualTimeDeadlock, VirtualTimeLoop,
                    run)

__all__ = [
    "SimNode", "SimTuning", "make_genesis", "make_sim_node",
    "Scenario", "curated_suite", "run_scenario",
    "LinkPolicy", "MemConn", "MemNetwork", "MemTransport",
    "VirtualClock", "VirtualTimeDeadlock", "VirtualTimeLoop", "run",
]
