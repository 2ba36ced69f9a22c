"""Evidence of Byzantine behaviour (counterpart of
``cometbft_tpu/evidence``): verification and the pool.  The gossip
reactor comes with the networked node."""

from .pool import EvidencePool
from .verify import verify_evidence

__all__ = ["EvidencePool", "verify_evidence"]
