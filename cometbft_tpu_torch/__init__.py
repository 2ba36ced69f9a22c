"""PyTorch/CUDA port of the commit-, light-header and BLS aggregate-commit
verification paths of ``cometbft_tpu``.

The package mirrors the module names of the JAX package, so each module's
counterpart is found under the same relative path.  It imports ``torch``,
``numpy`` and the standard library only.  Every entry point runs on the
CUDA device unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead of the kernel.
"""

__all__ = ["device"]
