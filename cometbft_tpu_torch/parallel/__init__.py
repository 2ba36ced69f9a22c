"""Lane sharding over a set of devices (``parallel/mesh.py``)."""
