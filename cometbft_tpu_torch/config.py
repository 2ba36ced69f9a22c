"""Consensus configuration (counterpart of the ``ConsensusConfig`` part of
``cometbft_tpu/config.py:16-60``; reference: ``config/config.go:1189-1225``).

Timeouts are in nanoseconds.  :func:`test_consensus_config` shrinks them
to tens of milliseconds for in-process multi-validator networks.  The
rest of the node's configuration tree comes with the networked node.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["NS", "MS", "ConsensusConfig", "test_consensus_config"]

NS = 1_000_000_000
MS = 1_000_000


@dataclass
class ConsensusConfig:
    """Timeouts in ns (defaults: config/config.go:1189-1207)."""

    timeout_propose: int = 3 * NS
    timeout_propose_delta: int = 500 * MS
    timeout_prevote: int = 1 * NS
    timeout_prevote_delta: int = 500 * MS
    timeout_precommit: int = 1 * NS
    timeout_precommit_delta: int = 500 * MS
    timeout_commit: int = 1 * NS
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: int = 0
    peer_gossip_sleep_duration: int = 100 * MS
    peer_query_maj23_sleep_duration: int = 2 * NS
    wal_path: str = "data/cs.wal"

    def propose_timeout(self, round_: int) -> int:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote_timeout(self, round_: int) -> int:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit_timeout(self, round_: int) -> int:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    def commit_timeout(self) -> int:
        return self.timeout_commit


def test_consensus_config() -> ConsensusConfig:
    """Shrunk timeouts for in-proc multi-validator tests
    (config/config.go:1210 TestConsensusConfig pattern)."""
    return ConsensusConfig(
        timeout_propose=80 * MS, timeout_propose_delta=20 * MS,
        timeout_prevote=40 * MS, timeout_prevote_delta=10 * MS,
        timeout_precommit=40 * MS, timeout_precommit_delta=10 * MS,
        timeout_commit=20 * MS, peer_gossip_sleep_duration=5 * MS)
