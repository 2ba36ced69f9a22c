"""Validator signers (counterpart of ``cometbft_tpu/privval``): the file
signer with its double-sign guard.  The remote signer
(``privval/signer.py``) comes later."""

from .file import DoubleSignError, FilePV, SignStateError

__all__ = ["FilePV", "DoubleSignError", "SignStateError"]
