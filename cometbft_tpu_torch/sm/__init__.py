"""State-machine replication core (counterpart of ``cometbft_tpu/sm``;
reference: ``state/``): the block executor, block validation, state
transitions and the pruner."""

from .execution import BlockExecutor, NopEvidencePool
from .pruner import Pruner
from .validation import BlockValidationError, validate_block

__all__ = ["BlockExecutor", "NopEvidencePool", "Pruner", "validate_block",
           "BlockValidationError"]
