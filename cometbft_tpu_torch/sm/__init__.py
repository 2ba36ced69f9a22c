"""State-machine replication core (counterpart of ``cometbft_tpu/sm``;
reference: ``state/``): the block executor, block validation and state
transitions."""

from .execution import BlockExecutor, NopEvidencePool
from .validation import BlockValidationError, validate_block

__all__ = ["BlockExecutor", "NopEvidencePool", "validate_block",
           "BlockValidationError"]
