"""Light-client header verification (counterpart of
``cometbft_tpu/light``).  The client, its store, providers and the
divergence detector come with a later slice of the port."""

from .types import (ErrInvalidHeader, ErrNewValSetCantBeTrusted, LightBlock,
                    LightClientError)
from .verifier import (verify, verify_adjacent, verify_non_adjacent,
                       verify_sequential_batched)

__all__ = [
    "LightBlock", "LightClientError", "ErrInvalidHeader",
    "ErrNewValSetCantBeTrusted", "verify", "verify_adjacent",
    "verify_non_adjacent", "verify_sequential_batched",
]
