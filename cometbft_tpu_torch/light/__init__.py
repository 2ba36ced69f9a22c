"""Light client (counterpart of ``cometbft_tpu/light``): header
verification, the client with its trusted store, providers and the
divergence detector.  The RPC provider, the proxy and the light-serving
node come with later slices of the port."""

from .client import SEQUENTIAL, SKIPPING, Client, TrustOptions
from .detector import DivergenceError
from .provider import (ErrLightBlockNotFound, LocalNodeProvider, Provider,
                       ProviderError)
from .store import TrustedStore
from .types import (ErrInvalidHeader, ErrNewValSetCantBeTrusted, LightBlock,
                    LightClientError)
from .verifier import (verify, verify_adjacent, verify_non_adjacent,
                       verify_sequential_batched)

__all__ = [
    "Client", "TrustOptions", "SEQUENTIAL", "SKIPPING", "TrustedStore",
    "Provider", "LocalNodeProvider", "ProviderError",
    "ErrLightBlockNotFound", "LightBlock", "LightClientError",
    "ErrInvalidHeader", "ErrNewValSetCantBeTrusted", "DivergenceError",
    "verify", "verify_adjacent", "verify_non_adjacent",
    "verify_sequential_batched",
]
