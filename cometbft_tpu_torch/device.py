"""Device resolution (the counterpart of ``cometbft_tpu/jaxenv.py``).

Entry points take an explicit ``device`` argument.  ``None`` means the
CUDA device; asking for CUDA where no card is visible raises instead of
falling back, so a measurement can never silently run on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda[:n]"``/``torch.device`` as
    given.  Raises ``RuntimeError`` for CUDA without a card or past the
    visible cards, and ``ValueError`` for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"CUDA device {dev} requested but "
                f"{torch.cuda.device_count()} are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
