"""Multi-process verification over ``torch.distributed``
(``cometbft_tpu_torch/parallel/mesh.py``), held against the JAX
package's single-device functions on the CPU.

Two, then three gloo processes (``tests/torch_multihost_child.py``), and
two processes of two shards each (the JAX package's multi-host test runs
two processes of two devices, ``tests/_multihost_child.py``), run
``sharded_kernel`` of every kind on ``device="cpu"`` over the same
seeded batches: 16 lanes (ragged over three ranks: 6, 6 and 4 lanes) and
their first 2 (an empty shard over three ranks), valid and mixed (the
tamper surfaces and ZIP-215 edge lanes of ``tests/test_torch_verify.py``),
and 13 and 2 merkle pairs.  Every rank's results must be the same, equal
the port's single-process route, and equal ``jax.jit`` of the JAX
package's single-device functions exactly: ``verify_padded_gather``
(``verify``: over a table of the lanes' own keys, as
``verify_padded``), ``verify_batch_rlc_gather`` (``rlc``: likewise, as
``verify_batch_rlc``) and ``merkle_inner_level``.  JAX runs 16 lanes, the
shapes ``tests/test_torch_verify.py`` compiles; a 2-lane case runs there
as its lanes followed by copies of lane 0 with z = 0, which add the
identity to every RLC window and nothing to the scalar sum, and whose
per-lane verdicts are cut off.  The stacked per-shard sums every rank
gathered equal those of one process byte for byte (the RLC verdict folds
them in shard order).  The tolerance is zero.  The cases of
``tests/test_batch_verifier.py:159`` and ``tests/test_mesh_sharded.py:
234-290`` are mirrored on ``init_multihost``; children are killed on
timeout."""

import functools
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519 as jed
from cometbft_tpu.ops import rlc as jrlc
from cometbft_tpu.ops import sha256 as jsha
from cometbft_tpu_torch import parallel
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519 as ted
from cometbft_tpu_torch.ops import rlc as trlc
from cometbft_tpu_torch.ops import sha256 as tsha
from cometbft_tpu_torch.parallel import mesh as M
from test_torch_verify import LANES, Batch, _base_lanes, _mixed_batch

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_multihost_child.py")
CHILD_TIMEOUT_S = 240
KINDS = ("verify", "gather", "rlc", "rlc_gather", "merkle_level")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Case:
    """The first ``k`` lanes of a 16-lane batch, and ``pairs`` merkle
    pairs, as the port takes them and as JAX runs them (16 lanes)."""

    def __init__(self, batch: Batch, k: int, pairs: int, seed: int):
        rng = np.random.default_rng(seed)
        self.batch, self.k = batch, k
        self.raw = rng.bytes(16 * k)
        self.z = trlc.host_rlc_coeffs(k, rng_bytes=self.raw)
        self.left = rng.integers(0, 2**32, (pairs, 8), dtype=np.uint32)
        self.right = rng.integers(0, 2**32, (pairs, 8), dtype=np.uint32)
        b = batch
        self.pub = b.pubs[b.idx]                  # each lane's own key
        self.port = {
            "pub": self.pub[:k], "tab": None, "ok": None,
            "idx": b.idx[:k], "rb": b.rb[:k], "sb": b.sb[:k],
            "blocks": b.blocks.view(np.int32)[:k], "active": b.active[:k],
            "z": self.z, "left": self.left.view(np.int32),
            "right": self.right.view(np.int32)}
        tab, ok = ted.prepare_pubkey_tables(torch.from_numpy(b.pubs.copy()))
        self.port["tab"], self.port["ok"] = tab.numpy(), ok.numpy()

    def torch(self, name):
        return torch.from_numpy(np.ascontiguousarray(self.port[name]))

    @functools.cached_property
    def single(self) -> dict:
        """The port's single-process route, kind by kind."""
        t = self.torch
        lanes = [t(n) for n in ("rb", "sb", "blocks", "active")]
        one = M.batch_mesh(["cpu"])
        return {
            "verify": ted.verify_padded(t("pub"), *lanes).numpy(),
            "gather": ted.verify_padded_gather(t("tab"), t("ok"), t("idx"),
                                               *lanes).numpy(),
            "rlc": trlc.make_verify_batch_rlc_sharded(one)(
                t("pub"), *lanes, t("z")).numpy(),
            "rlc_gather": trlc.verify_batch_rlc_gather(
                t("tab"), t("ok"), t("idx"), *lanes, t("z")).numpy(),
            "merkle_level": tsha.merkle_inner_level(t("left"),
                                                    t("right")).numpy()}

    def stack(self, shards: int):
        """The stacked per-shard sums one process folds for ``rlc_gather``
        over ``shards`` shards, as the child records them."""
        seen = []

        def record(sums, zs, ok):
            seen.append(np.concatenate([t.numpy().reshape(t.shape[0], -1)
                                        .view(np.uint8)
                                        for t in (sums, zs, ok)], 1))
            return combine(sums, zs, ok)

        t = self.torch
        combine, trlc.rlc_combine = trlc.rlc_combine, record
        try:
            trlc.make_verify_batch_rlc_sharded(
                M.batch_mesh(["cpu"] * shards), gather=True)(
                t("tab"), t("ok"), t("idx"), t("rb"), t("sb"), t("blocks"),
                t("active"), t("z"))
        finally:
            trlc.rlc_combine = combine
        return seen[0]

    def jax(self, fns) -> dict:
        """JAX's single-device functions over the 16-lane batch, the
        lanes past ``k`` copies of lane 0 with z = 0."""
        b, k = self.batch, self.k
        pad = np.r_[np.arange(k), np.zeros(LANES - k, int)]
        z10 = jrlc.host_rlc_coeffs(LANES, active_mask=np.arange(LANES) < k,
                                   rng_bytes=self.raw + bytes(16 * (LANES - k)))
        idx, rb, sb, blocks, active = (a[pad] for a in b.jax_args())
        own = np.arange(LANES, dtype=np.int32)
        jtab, jok = fns["tables"](b.pubs.astype(np.int32))
        otab, ook = fns["tables"](self.pub[pad].astype(np.int32))
        lanes = (rb, sb, blocks, active)
        return {
            "verify": np.asarray(fns["gather"](otab, ook, own, *lanes))[:k],
            "gather": np.asarray(fns["gather"](jtab, jok, idx, *lanes))[:k],
            "rlc": np.asarray(fns["rlc_gather"](otab, ook, own, *lanes,
                                                z10)),
            "rlc_gather": np.asarray(fns["rlc_gather"](jtab, jok, idx,
                                                       *lanes, z10)),
            "merkle_level": np.asarray(fns["merkle_level"](
                self.left, self.right)).view(np.int32)}


@pytest.fixture(scope="module")
def cases():
    valid, mixed = Batch(_base_lanes(82)), _mixed_batch()
    return {"valid16": Case(valid, 16, 13, 1), "mixed16": Case(mixed, 16, 13, 2),
            "valid2": Case(valid, 2, 2, 3), "mixed2": Case(mixed, 2, 2, 4)}


@pytest.fixture(scope="module")
def jax_refs(cases):
    """JAX's results of every case, compiled once, at the shapes
    ``tests/test_torch_verify.py`` uses."""
    fns = {"tables": jax.jit(jed.prepare_pubkey_tables),
           "gather": jax.jit(jed.verify_padded_gather),
           "rlc_gather": jax.jit(jrlc.verify_batch_rlc_gather),
           "merkle_level": jax.jit(jsha.merkle_inner_level)}
    return {name: case.jax(fns) for name, case in cases.items()}


def _run_group(tmp_path, cases, world: int, local: int) -> list:
    """``world`` child processes over one gloo group; each rank's results
    (killed, and failed, past ``CHILD_TIMEOUT_S``)."""
    src = tmp_path / "cases.npz"
    np.savez(src, **{f"{n}/{k}": np.ascontiguousarray(v)
                     for n, c in cases.items() for k, v in c.port.items()})
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(port), str(r), str(world), str(local),
         str(src), str(tmp_path / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for r in range(world)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail("multihost children timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


@pytest.mark.parametrize("world,local", [(2, 1), (3, 1), (2, 2)],
                         ids=["2-ranks", "3-ranks", "2-ranks-2-shards"])
def test_ranks_equal_single_process_and_jax(tmp_path, cases, jax_refs,
                                            world, local):
    ranks = _run_group(tmp_path, cases, world, local)
    for r, got in enumerate(ranks):
        first = sum([local] * r)
        assert list(got["shape"]) == [world * local, r, first]
    for name, case in cases.items():
        single, ref = case.single, jax_refs[name]
        for kind in KINDS:
            for r, got in enumerate(ranks):
                assert np.array_equal(got[f"{name}/{kind}"], single[kind]), \
                    (name, kind, r)
            assert np.array_equal(single[kind], ref[kind]), (name, kind)
        stack = case.stack(world * local)
        for got in ranks:
            assert np.array_equal(got[f"{name}/stack"], stack), name
        assert bool(single["rlc"]) == (name.startswith("valid"))


def test_expected_verdicts(cases):
    """The cases mean what they say: valid lanes all pass, the mixed
    batch's per-lane verdicts are the oracle's, so the RLC rejects."""
    for name, case in cases.items():
        oracle = case.batch.oracle()[:case.k]
        assert list(case.single["gather"]) == oracle, name


def test_gather_slots_and_lanes_fill_every_rank(monkeypatch):
    """The collectives' packing on a group whose all-gather returns each
    rank's rows as given (monkeypatched): slots of the other ranks are
    filled in rank order, lanes come back whole, empty ranks included."""
    import torch.distributed as dist

    mesh = M.ProcessMesh((torch.device("cpu"),) * 3, counts=(1, 1, 1),
                         rank=1, group=None)
    sums = trlc.rlc_sums_buffers(3, "cpu")
    for t in sums:
        t.zero_()
    sums.sums[1] = 7
    sums.zs[1] = 9
    sums.ok[1] = 1
    width = 96 * 40 * 4 + 32 + 1
    rows = [torch.full((1, width), r, dtype=torch.uint8) for r in range(3)]

    def gather(out, t, group=None):
        rows[1] = t.clone()
        for r, o in enumerate(out):
            o.copy_(rows[r])

    monkeypatch.setattr(dist, "all_gather", gather)
    before = dict(M.GATHER_STATS)
    mesh.gather_slots(*sums)
    assert M.GATHER_STATS["calls"] == before["calls"] + 1
    assert M.GATHER_STATS["bytes"] == before["bytes"] + width
    assert torch.equal(sums.sums[1], torch.full((96, 40), 7, dtype=torch.int32))
    assert torch.equal(sums.sums[0].view(torch.uint8),
                       torch.zeros((96, 160), dtype=torch.uint8))
    assert torch.equal(sums.sums[2].view(torch.uint8),
                       torch.full((96, 160), 2, dtype=torch.uint8))
    assert int(sums.zs[2][0]) == 2 and int(sums.ok[2]) == 2
    assert int(sums.zs[1][0]) == 9 and int(sums.ok[1]) == 1
    # lanes: 2 lanes over 3 ranks, the last rank's shard empty
    views = {0: torch.tensor([True]), 1: torch.tensor([False]),
             2: torch.zeros((0,), dtype=torch.bool)}

    def lanes_gather(out, t, group=None):
        for r, o in enumerate(out):
            o.zero_()
            o[:views[r].shape[0]] = views[r].view(torch.uint8)[:, None]

    monkeypatch.setattr(dist, "all_gather", lanes_gather)
    for rank in range(3):
        m = M.ProcessMesh(mesh.devices, counts=(1, 1, 1), rank=rank)
        assert m.gather_lanes(views[rank], 2).tolist() == [True, False]
    with pytest.raises(ValueError, match="holds"):
        mesh.gather_lanes(torch.zeros((2,), dtype=torch.bool), 2)


def test_local_view_names_only_this_ranks_shards():
    devs = (torch.device("cpu"),) * 5
    m = M.ProcessMesh(devs, counts=(2, 1, 2), rank=2)
    assert m.world_size == 3 and m.first == 3 and m.size == 5
    assert m.local_view() == (None, None, None) + devs[3:]
    parts = M.split(m.local_view(), torch.arange(12))
    assert parts[:3] == [None] * 3
    assert [p[0].tolist() for p in parts[3:]] == [[9, 10, 11], []]
    (dev, slots, offs, slab), = M.split_by_device(m.local_view(),
                                                  torch.arange(12))
    assert slots == [3, 4] and offs == [0, 3, 3]
    assert slab[0].tolist() == [9, 10, 11]
    assert list(M.replicate(torch.ones(2), m.local_view())) == [devs[0]]


# -------------------------------------- init_multihost's rules, one process

@pytest.fixture
def no_launcher_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)


def test_init_multihost_single_host_default(no_launcher_env):
    """Mirror of ``tests/test_batch_verifier.py:159``: without a
    coordinator, the one-process mesh and no initialisation; process
    arguments without one raise."""
    import torch.distributed as dist

    with pytest.raises(ValueError):
        parallel.init_multihost(num_processes=4)
    with pytest.raises(ValueError):
        parallel.init_multihost(process_id=0)
    mesh = parallel.init_multihost(device="cpu")
    assert mesh == parallel.batch_mesh(["cpu"])
    assert type(mesh) is M.Mesh and not dist.is_initialized()
    assert parallel.init_multihost(device=["cpu", "cpu"]).size == 2


def test_init_multihost_reads_launcher_env_not_jax(monkeypatch,
                                                   no_launcher_env):
    """The PyTorch launcher's variables are the defaults; a
    ``JAX_COORDINATOR_ADDRESS`` alone initialises nothing."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    assert type(parallel.init_multihost(device="cpu")) is M.Mesh
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29555")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")

    def fake_init(backend, init_method=None, world_size=None, rank=None,
                  timeout=None):
        calls.append((backend, init_method, world_size, rank,
                      timeout.total_seconds()))
        monkeypatch.setattr(dist, "is_initialized", lambda: True)

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj, group=None: out.__setitem__(0, obj))
    monkeypatch.setattr(M.atexit, "register", lambda fn: None)
    mesh = parallel.init_multihost(device="cpu", timeout_s=7)
    assert calls == [("gloo", "tcp://127.0.0.1:29555", 1, 0, 7.0)]
    assert isinstance(mesh, M.ProcessMesh) and mesh.counts == (1,)
    # an initialised group is reused: no second init
    parallel.init_multihost(device="cpu")
    assert len(calls) == 1
    # ... and must agree with the arguments
    with pytest.raises(ValueError, match="initialised as rank 0 of 1"):
        parallel.init_multihost(coordinator="127.0.0.1:29555",
                                num_processes=2, process_id=1, device="cpu")


def test_init_multihost_without_card_or_rank_raises(monkeypatch,
                                                    no_launcher_env):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: pytest.fail("initialised"))
    with pytest.raises(ValueError, match="needs num_processes"):
        parallel.init_multihost(coordinator="127.0.0.1:1", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            parallel.init_multihost(coordinator="127.0.0.1:1",
                                    num_processes=1, process_id=0)


def test_rank_that_never_arrives_fails_the_call(tmp_path):
    """Rank 0 of two waits ``timeout_s`` for a rank that never comes and
    raises instead of hanging."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from cometbft_tpu_torch.parallel import init_multihost\n"
            "try:\n"
            "    init_multihost(coordinator='127.0.0.1:%d', num_processes=2,"
            " process_id=0, device='cpu', timeout_s=3)\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__); sys.exit(0)\n"
            "sys.exit(1)\n") % (REPO, _free_port())
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "RAISED" in proc.stdout, \
        proc.stdout + proc.stderr
    assert time.monotonic() - t0 < 100


def test_sharded_kernel_kinds_and_names():
    """``sharded_verify_fn`` is the verify program; an unknown kind
    raises as in the JAX package; the one-process mesh runs every kind
    with no collective."""
    mesh = M.batch_mesh(["cpu", "cpu"])
    with pytest.raises(KeyError):
        M.sharded_kernel("tables", mesh=mesh)
    left = torch.arange(24, dtype=torch.int32).reshape(3, 8)
    got = M.sharded_kernel("merkle_level", mesh=mesh)(left, left + 1)
    assert torch.equal(got, tsha.merkle_inner_level(left, left + 1))
    assert M.sharded_kernel("merkle_level", devices=["cpu"])(
        left, left).shape == (3, 8)
    _build.PLAIN_CALLS.clear()
    assert set(parallel.__all__) == {"batch_mesh", "init_multihost",
                                     "sharded_verify_fn"}
