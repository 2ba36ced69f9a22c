"""One rank of ``tests/test_torch_multihost.py``: a process of a gloo group
of the port's ``init_multihost`` on ``device="cpu"``.

    python tests/torch_multihost_child.py PORT RANK WORLD LOCAL IN OUT

loads the cases of ``IN`` (an ``.npz`` the test wrote), runs each through
``sharded_kernel`` of every kind over the group (``LOCAL`` shards a rank,
the device ``cpu`` named ``LOCAL`` times), and writes this rank's
results, the stacked per-shard RLC sums its ``rlc_gather`` folded, and
its mesh's shape to ``OUT`` (an ``.npz``).  Imports nothing
of the JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cometbft_tpu_torch.ops import rlc as _rlc  # noqa: E402
from cometbft_tpu_torch.parallel import init_multihost, sharded_verify_fn  # noqa: E402
from cometbft_tpu_torch.parallel.mesh import ProcessMesh, sharded_kernel  # noqa: E402

torch.set_num_threads(1)
STACKS = []
_combine = _rlc.rlc_combine


def _recording_combine(sums, zs, ok):
    """``rlc_combine``, keeping the stack it folds (every rank's slots)."""
    STACKS.append(np.concatenate([t.numpy().reshape(t.shape[0], -1).view(
        np.uint8) for t in (sums, zs, ok)], 1))
    return _combine(sums, zs, ok)


_rlc.rlc_combine = _recording_combine


def main() -> None:
    port, rank, world, local = (int(a) for a in sys.argv[1:5])
    src, dst = sys.argv[5:7]
    mesh = init_multihost(coordinator=f"127.0.0.1:{port}",
                          num_processes=world, process_id=rank,
                          device=["cpu"] * local)
    assert isinstance(mesh, ProcessMesh) and mesh.size == world * local
    # an initialised group is reused, not initialised again
    again = init_multihost(coordinator=f"127.0.0.1:{port}", device="cpu")
    assert again.counts == (1,) * world and again.rank == rank
    fns = {k: sharded_kernel(k, mesh=mesh)
           for k in ("gather", "rlc", "rlc_gather", "merkle_level")}
    fns["verify"] = sharded_verify_fn(mesh)
    data = np.load(src)
    out = {"shape": np.array([mesh.size, mesh.rank, mesh.first])}
    for case in sorted({k.split("/")[0] for k in data.files}):
        a = {k.split("/")[1]: torch.from_numpy(data[k].copy())
             for k in data.files if k.startswith(case + "/")}
        lanes = (a["rb"], a["sb"], a["blocks"], a["active"])
        out[f"{case}/verify"] = fns["verify"](a["pub"], *lanes).numpy()
        out[f"{case}/gather"] = fns["gather"](a["tab"], a["ok"], a["idx"],
                                              *lanes).numpy()
        out[f"{case}/rlc"] = fns["rlc"](a["pub"], *lanes, a["z"]).numpy()
        out[f"{case}/rlc_gather"] = fns["rlc_gather"](
            a["tab"], a["ok"], a["idx"], *lanes, a["z"]).numpy()
        out[f"{case}/stack"] = STACKS[-1]
        out[f"{case}/merkle_level"] = fns["merkle_level"](
            a["left"], a["right"]).numpy()
    np.savez(dst, **out)


if __name__ == "__main__":
    main()
