"""Light client (counterpart of ``cometbft_tpu/light``): header
verification, the client with its trusted store, providers (local and
over RPC) and the divergence detector; the verified RPC proxy; and the
serving tier a full node runs for a fleet of light clients
(``light/serve.py``)."""

from .client import SEQUENTIAL, SKIPPING, Client, TrustOptions
from .detector import DivergenceError
from .provider import (ErrLightBlockNotFound, LocalNodeProvider, Provider,
                       ProviderError)
from .proxy import LightProxy, run_light_proxy
from .rpc_provider import RPCProvider
from .serve import LightServeError, LightServeTier
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
    "verify_sequential_batched", "RPCProvider", "LightProxy",
    "run_light_proxy", "LightServeTier", "LightServeError",
]
