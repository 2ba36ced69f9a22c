"""Evidence of Byzantine behaviour (counterpart of
``cometbft_tpu/evidence``): verification, the pool and the gossip
reactor."""

from .pool import EvidencePool
from .reactor import EvidenceReactor
from .verify import verify_evidence

__all__ = ["EvidencePool", "EvidenceReactor", "verify_evidence"]
