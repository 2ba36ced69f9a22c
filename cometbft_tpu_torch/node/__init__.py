"""The node (counterpart of ``cometbft_tpu/node``): assembly and
lifecycle of one full node or validator."""

from .node import Node

__all__ = ["Node"]
