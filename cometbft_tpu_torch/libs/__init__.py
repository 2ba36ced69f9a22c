"""Small libraries of the node (counterpart of ``cometbft_tpu/libs``)."""
