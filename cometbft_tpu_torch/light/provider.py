"""Light-block providers (reference: ``light/provider/provider.go``).

Counterpart of ``cometbft_tpu/light/provider.py``.  ``LocalNodeProvider``
serves light blocks from a node's block store and state store, which it
duck-types (``height``, ``load_block``, ``load_block_commit``,
``load_seen_commit``; ``load_validators``): the port's stores come with a
later slice.  The RPC provider (``light/rpc_provider.py``) waits for the
port's RPC client.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from .types import LightBlock, LightClientError

__all__ = ["ProviderError", "ErrLightBlockNotFound", "Provider",
           "LocalNodeProvider"]


class ProviderError(LightClientError):
    pass


class ErrLightBlockNotFound(ProviderError):
    pass


class Provider(ABC):
    @abstractmethod
    async def light_block(self, height: int) -> LightBlock:
        """Light block at height (0 = latest).  Raises
        ErrLightBlockNotFound."""

    async def report_evidence(self, evidence) -> None:
        """Deliver attack evidence to the peer behind this provider (the
        detector sends each side's evidence to the other).  Default: no
        channel to submit on; the evidence is dropped."""

    def id(self) -> str:
        return type(self).__name__


class LocalNodeProvider(Provider):
    def __init__(self, block_store, state_store, name: str = "local",
                 evidence_pool=None):
        self.block_store = block_store
        self.state_store = state_store
        self.name = name
        self.evidence_pool = evidence_pool
        self.received_evidence: list = []

    def id(self) -> str:
        return self.name

    async def report_evidence(self, evidence) -> None:
        """Record reported attack evidence and, where a pool is wired,
        submit it (best effort)."""
        self.received_evidence.append(evidence)
        if self.evidence_pool is not None:
            try:
                self.evidence_pool.add_evidence(evidence)
            except Exception:
                pass

    async def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = self.block_store.height()
        block = self.block_store.load_block(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            seen = self.block_store.load_seen_commit()
            if seen is not None and seen.height == height:
                commit = seen
        vals = self.state_store.load_validators(height)
        if block is None or commit is None or vals is None:
            raise ErrLightBlockNotFound(
                f"{self.name}: no light block at height {height}")
        return LightBlock(header=block.header, commit=commit,
                          validators=vals)
