"""PyTorch/CUDA port of ``cometbft_tpu``: commit, light-header and BLS
aggregate-commit verification, the light client, blocksync, consensus
and the networked node.

The package mirrors the module names of the JAX package, so each module's
counterpart is found under the same relative path.  It imports ``torch``,
``numpy`` and the standard library only.  Every entry point runs on the
CUDA device unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead of the kernel.
"""

__all__ = ["device", "__version__"]

# the JAX package's version: the gRPC version service reports it
__version__ = "0.1.0"
