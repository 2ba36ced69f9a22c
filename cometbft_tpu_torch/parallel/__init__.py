"""Lane sharding over a set of devices, in one process or over the
processes of a ``torch.distributed`` group (``parallel/mesh.py``)."""

from .mesh import batch_mesh, init_multihost, sharded_verify_fn

__all__ = ["batch_mesh", "init_multihost", "sharded_verify_fn"]
