"""The node (counterpart of ``cometbft_tpu/node``): assembly and
lifecycle of one full node or validator, the storage doctor
(``doctor.py``) and the liveness watchdog (``watchdog.py``)."""

from .node import Node

__all__ = ["Node"]
