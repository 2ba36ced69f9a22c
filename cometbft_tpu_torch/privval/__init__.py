"""Validator signers (counterpart of ``cometbft_tpu/privval``): the file
signer with its double-sign guard, and the remote signer
(``privval/signer.py``): the node listens, the signer dials in."""

from .file import DoubleSignError, FilePV, SignStateError
from .signer import (RemoteSignerError, SignerClient, SignerListener,
                     SignerServer, SignerTimeoutError, serve_dialer)

__all__ = ["FilePV", "DoubleSignError", "SignStateError",
           "RemoteSignerError", "SignerTimeoutError", "SignerServer",
           "SignerClient", "SignerListener", "serve_dialer"]
