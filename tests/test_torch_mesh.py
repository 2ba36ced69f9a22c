"""The lane-sharded RLC verdict (K7), the device set and the sharded
dispatch, held against the JAX package on the CPU.

Shards are ``["cpu"] * D``: the same device named D times, as the JAX
package runs its mesh over emulated CPU devices.  The JAX package's own
sharded program (``jax.jit(make_verify_batch_rlc_sharded(mesh))``) does
not trace under the installed jax: ``shard_map`` refuses the SHA-512
``fori_loop`` carry inside ``_rlc_sums`` for its varying manual axes.  So
the port is held against what that program computes, composed from the
JAX package's pieces: ``jax.jit(_rlc_sums)`` per shard, then
``_combine``'s ``_g.add_cc`` chain in shard order, ``scalar.sum_mod_l``
and ``jax.jit(_rlc_ladder)``.  ``_rlc_sums`` is compiled once at 16
lanes: a shard runs as its lanes followed by z = 0 padding lanes, which
add the identity to every window and nothing to the scalar sum.  JAX's
single-device verdict is ``_rlc_core`` of the whole batch, the same
pieces with one shard.  Ragged and empty shards, which a JAX mesh cannot
take, are held against that single-device verdict.  The 32 R window
sums compare as points (the two packages add in different orders).  The
64 A windows take their digits from z*h mod L, which the JAX package
keeps as some representative below 2^256 and the port reduces fully
(``ops/scalar.py``), so they compare as the one point the ladder makes
of them, the sum over w of [16^w] S_w, times the cofactor: the two
representatives differ by a multiple of L, which leaves a torsion part
on a mixed-order key, and the verdict's check is cofactored too.  Scalar
sums compare mod L,
verdicts and localisations exactly: the tolerance is zero."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_py as ref
from cometbft_tpu.ops import ed25519 as jed
from cometbft_tpu.ops import rlc as jrlc
from cometbft_tpu.ops.group import Cached as JCached
from cometbft_tpu.testing import make_light_chain
from cometbft_tpu.types import validation as JV
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import plan
from cometbft_tpu_torch.ops import _build, fe
from cometbft_tpu_torch.ops import ed25519 as ted
from cometbft_tpu_torch.ops import rlc as trlc
from cometbft_tpu_torch.parallel import mesh as M
from cometbft_tpu_torch.types import validation as TV
from test_torch_light import _random_set, port_block
from test_torch_verify import LANES, Batch, _base_lanes, _edge_lanes

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)

L, P = ref.L, ref.P


@pytest.fixture(autouse=True)
def clean_plan():
    yield
    plan.set_devices(None)
    tbatch.DISPATCHES.clear()


def _jax_sums(tab, ok_a, idx, rb, sb, blocks, active, z10):
    lane_tab = JCached(*[jnp.take(c, idx, axis=2) for c in tab])
    return jrlc._rlc_sums(lane_tab, jnp.take(ok_a, idx, axis=0), rb, sb,
                          blocks, active, z10)


@pytest.fixture(scope="module")
def jax_fns():
    return (jax.jit(jed.prepare_pubkey_tables), jax.jit(_jax_sums),
            jax.jit(jrlc._rlc_ladder))


def _affine(ypx, ymx, z2):
    zi = pow(z2 % P, P - 2, P)
    return ((ypx - ymx) * zi % P, (ypx + ymx) * zi % P)


def _port_points(rows):
    """(96, 40) cached window rows -> 96 affine points."""
    return [_affine(*(fe.int_from_limbs([int(v) for v in r[k:k + 10]])
                      for k in (0, 10, 20))) for r in np.asarray(rows)]


def _jax_points(sum_a, sum_r):
    """JAX cached window sums, 13-bit limbs of (20, 64) and (20, 32) ->
    96 affine points."""
    def val(c, w):
        return sum(int(v) << (13 * i) for i, v in enumerate(c[:, w]))

    out = []
    for s in (sum_a, sum_r):
        ypx, ymx, z2 = (np.asarray(c) for c in (s.ypx, s.ymx, s.z2))
        out += [_affine(val(ypx, w), val(ymx, w), val(z2, w))
                for w in range(ypx.shape[1])]
    return out


def _windows_match(port, jax_):
    """96 window points of each package: the R windows equal, and [8]
    times the A windows' Horner sum over [16^w] equal."""
    def horner(pts):
        acc = ref.IDENTITY
        for x, y in reversed(pts):
            acc = ref.pt_add(ref.pt_mul(16, acc), (x, y, 1, x * y % P))
        return ref.pt_mul(8, acc)

    return port[64:] == jax_[64:] and ref.pt_equal(horner(port[:64]),
                                                   horner(jax_[:64]))


def _jax_scalar(limbs) -> int:
    return sum(int(v) << (13 * i) for i, v in enumerate(np.asarray(limbs)))


def _cases():
    """(name, lanes, active mask, expected verdict) of 16 lanes each."""
    rng = np.random.default_rng(81)
    valid = _base_lanes(82)
    torsion = list(valid)
    torsion[9:12] = _edge_lanes(rng)
    tampered = list(torsion)
    pk, m, s = tampered[13]
    tampered[13] = (pk, m, s[:33] + bytes([s[33] ^ 1]) + s[34:])
    garbage = list(torsion)
    for i in (13, 14, 15):
        garbage[i] = (garbage[i][0], garbage[i][1], b"\xff" * 64)
    return [("valid", valid, None, True),
            ("torsion edges", torsion, None, True),
            ("tampered", tampered, None, False),
            ("garbage padding", garbage, np.arange(LANES) < 13, True)]


class Both:
    """One 16-lane case in both packages, with pinned coefficients."""

    def __init__(self, jax_fns, case, seed):
        self.name, lanes, active, self.expect = _cases()[case]
        self.b = Batch(lanes)
        raw = np.random.default_rng(seed).bytes(16 * LANES)
        self.jz = jrlc.host_rlc_coeffs(LANES, active_mask=active,
                                       rng_bytes=raw)
        self.tz = trlc.host_rlc_coeffs(LANES, active_mask=active,
                                       rng_bytes=raw)
        self.jtab, self.jok = jax_fns[0](self.b.pubs.astype(np.int32))
        self.ttab, self.tok = ted.prepare_pubkey_tables(
            torch.from_numpy(self.b.pubs.copy()))
        self.fns = jax_fns

    def torch_args(self):
        return (self.ttab, self.tok, *self.b.torch_args(),
                torch.from_numpy(self.tz))

    def jax_shard(self, lo, hi):
        """JAX ``_rlc_sums`` of lanes [lo, hi), padded to 16 lanes with
        z = 0 lanes."""
        pad = np.r_[np.arange(lo, hi), np.zeros(LANES - (hi - lo), int)]
        z = self.jz[pad].copy()
        z[hi - lo:] = 0
        return self.fns[1](self.jtab, self.jok,
                           *[a[pad] for a in self.b.jax_args()], z)

    def jax_combine(self, bounds) -> bool:
        """``_combine`` of the JAX package over the shards ``bounds``."""
        parts = [self.jax_shard(lo, hi) for lo, hi in bounds]
        sum_a, sum_r = parts[0][0], parts[0][1]
        for p in parts[1:]:
            sum_a = jrlc._g.add_cc(sum_a, p[0])
            sum_r = jrlc._g.add_cc(sum_r, p[1])
        zs = jrlc.scalar.sum_mod_l(jnp.stack([p[2] for p in parts]), axis=0)
        ok = all(bool(p[3]) for p in parts)
        return ok and bool(self.fns[2](sum_a, sum_r, zs))


# ------------------------------------------------------------- the pieces

@pytest.mark.parametrize("bounds", [[(0, 16)], [(0, 8), (8, 16)],
                                    [(0, 6), (6, 12), (12, 16)],
                                    [(16, 16)]],
                         ids=["whole", "half", "ragged", "empty"])
def test_shard_sums_match_jax(jax_fns, bounds):
    """Per shard, the port's plain lane stage and window fold
    (``rlc_sums_gather`` on CPU tensors) against JAX's ``_rlc_sums``:
    window sums as points, sum z*s mod L, lane checks."""
    both = Both(jax_fns, 1, 90)
    args = both.torch_args()
    for lo, hi in bounds:
        part = trlc.rlc_sums_gather(*[a[lo:hi] if i >= 2 else a
                                      for i, a in enumerate(args)])
        sa, sr, zs, ok = both.jax_shard(lo, hi)
        assert _windows_match(_port_points(part.sums[0]),
                              _jax_points(sa, sr))
        assert int.from_bytes(part.zs[0].numpy().tobytes(), "little") == \
            _jax_scalar(zs) % L
        assert bool(part.ok[0]) == bool(ok) is True


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_grouped_sums_match_jax(jax_fns, d):
    """All ``d`` shards of one device in one sums call (``_rlc_sums_card``
    on the device's slab from ``split_by_device``, the plain path): each
    slot against JAX's ``_rlc_sums`` of that shard, and the combined
    verdict against the JAX package's ``_combine`` of the same shards."""
    both = Both(jax_fns, 2 if d == 3 else 1, 95 + d)
    args = both.torch_args()
    bounds = M.shard_bounds(LANES, d)
    out = trlc.rlc_sums_buffers(d, "cpu")
    _build.reset_launches()
    for dev, slots, offs, lanes in M.split_by_device(["cpu"] * d, *args[2:]):
        assert slots == list(range(d)) and offs[-1] == LANES
        trlc._rlc_sums_card(*args[:2], *lanes, offs, slots, out)
    assert dict(_build.PLAIN_CALLS) == {"ed25519_rlc_sums": 1}
    for s, (lo, hi) in enumerate(bounds):
        sa, sr, zs, ok = both.jax_shard(lo, hi)
        assert _windows_match(_port_points(out.sums[s]), _jax_points(sa, sr))
        assert int.from_bytes(out.zs[s].numpy().tobytes(), "little") == \
            _jax_scalar(zs) % L
        assert bool(out.ok[s]) == bool(ok)
    assert bool(trlc._rlc_combine_plain(*out)) == both.jax_combine(bounds) \
        == both.expect


def test_combine_matches_jax(jax_fns):
    """``_rlc_combine_plain`` against JAX's ``add_cc`` chain,
    ``sum_mod_l`` and ``_rlc_ladder`` on the same shards; the combined
    window sums equal the whole batch's as points."""
    for case, expect in ((0, True), (2, False)):
        both = Both(jax_fns, case, 91)
        args = both.torch_args()
        bounds = M.shard_bounds(LANES, 3)
        out = trlc.rlc_sums_buffers(3, "cpu")
        for d, (lo, hi) in enumerate(bounds):
            trlc.rlc_sums_gather(*[a[lo:hi] if i >= 2 else a
                                   for i, a in enumerate(args)],
                                 out=out, slot=d)
        assert bool(trlc._rlc_combine_plain(*out)) == \
            both.jax_combine(bounds) == expect
        acc = trlc._unpack_sums(out.sums[0])
        for d in (1, 2):
            acc = trlc.group.add_cc(acc, trlc._unpack_sums(out.sums[d]))
        whole = trlc.rlc_sums_gather(*args)
        assert _port_points(trlc._pack_sums(
            trlc.Cached(*[c[:, :64] for c in acc]),
            trlc.Cached(*[c[:, 64:] for c in acc]))) == \
            _port_points(whole.sums[0])


# ------------------------------------------------------------ the verdict

@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("case", range(4))
def test_sharded_verdict_matches_jax(jax_fns, case, d):
    """``make_verify_batch_rlc_sharded`` over ``["cpu"] * d`` against the
    JAX package's sharded verdict composed from its pieces, and against
    its single-device verdict."""
    both = Both(jax_fns, case, 100 + case)
    fn = trlc.make_verify_batch_rlc_sharded(M.batch_mesh(["cpu"] * d),
                                            gather=True)
    bounds = M.shard_bounds(LANES, d)
    assert bool(fn(*both.torch_args())) == both.jax_combine(bounds) == \
        both.jax_combine([(0, LANES)]) == both.expect, both.name


@pytest.mark.parametrize("d", [3, 5, 32, 70])
def test_ragged_and_empty_shards_match_jax_single_device(jax_fns, d):
    """16 lanes over 3 (6, 6, 4), 5 (one empty shard), 32 devices
    (B < D: 16 one-lane shards and 16 empty) and 70 (more shards than one
    pass of the sums kernel takes; still one call on the one device): the
    sharded verdict
    equals JAX's single-device verdict on a valid and a tampered batch,
    and so does the uncached variant over 5 devices."""
    mesh = M.batch_mesh(["cpu"] * d)
    for case in (0, 2):
        both = Both(jax_fns, case, 110 + case)
        want = both.jax_combine([(0, LANES)])
        args = both.torch_args()
        _build.reset_launches()
        got = bool(trlc.make_verify_batch_rlc_sharded(mesh, True)(*args))
        assert got == want == both.expect, both.name
        assert _build.PLAIN_CALLS["ed25519_rlc_sums"] == 1
        if d == 5:
            pubs = torch.from_numpy(both.b.pubs[both.b.idx].copy())
            assert bool(trlc.make_verify_batch_rlc_sharded(mesh)(
                pubs, *args[3:])) == want


# ------------------------------------------------------ plan and dispatch

def test_resolve_devices_order_and_raise(monkeypatch):
    """An explicit device wins, then the device set (repeats kept), then
    every card where there are several, else CUDA, raising without a
    card."""
    cpu = torch.device("cpu")
    plan.set_devices(["cpu", "cpu", "cpu"])
    assert plan.resolve_devices("cpu") == (cpu,)
    assert plan.resolve_devices(None) == (cpu, cpu, cpu)
    plan.set_devices([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert plan.resolve_devices(None) == tuple(
        torch.device("cuda", i) for i in range(4))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert plan.resolve_devices(None) == (torch.device("cuda"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        plan.resolve_devices(None)


def test_launch_makes_the_tensors_card_current(monkeypatch):
    """``_build.launch`` calls the C entry with the tensor's card current
    and that card's current stream last, counts one launch, and raises on
    a failed launch: a shard on a second card must not launch on the
    thread's first card."""
    current, seen = [None], []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            self.prev, current[0] = current[0], self.dev

        def __exit__(self, *exc):
            current[0] = self.prev

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + dev.index

    def entry(*args):
        seen.append((current[0], args))
        return args[0]

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(_build, "load", lambda name: entry)

    class OnCard:
        device = torch.device("cuda", 2)

    _build.reset_launches()
    _build.launch("ed25519_rlc_sums", OnCard, 0, 7)
    assert seen == [(torch.device("cuda", 2), (0, 7, 1002))]
    assert current[0] is None
    assert _build.LAUNCHES == {"ed25519_rlc_sums": 1}
    with pytest.raises(RuntimeError, match="error 9"):
        _build.launch("ed25519_rlc_combine", OnCard, 9)
    assert current[0] is None


def test_shard_bounds():
    assert M.shard_bounds(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert M.shard_bounds(9, 4) == [(0, 3), (3, 6), (6, 9), (9, 9)]
    assert M.shard_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert M.shard_bounds(0, 2) == [(0, 0), (0, 0)]
    assert M.shard_bounds(7, 1) == [(0, 7)]
    lanes = torch.arange(7)
    slabs = M.split([torch.device("cpu", i) for i in range(4)], lanes,
                    2 * lanes)
    assert [[t.tolist() for t in s] for s in slabs] == [
        [[0, 1], [0, 2]], [[2, 3], [4, 6]], [[4, 5], [8, 10]], [[6], [12]]]
    # by device: a device's shards side by side in shard order, and the
    # tensors themselves where one device holds every shard
    two = [torch.device("cpu", i % 2) for i in range(4)]
    got = M.split_by_device(two, lanes, 2 * lanes)
    assert [(d, s, o, [t.tolist() for t in ts]) for d, s, o, ts in got] == [
        (two[0], [0, 2], [0, 2, 4], [[0, 1, 4, 5], [0, 2, 8, 10]]),
        (two[1], [1, 3], [0, 2, 3], [[2, 3, 6], [4, 6, 12]])]
    ((dev, slots, offs, ts),) = M.split_by_device([lanes.device] * 3, lanes)
    assert (slots, offs) == ([0, 1, 2], [0, 3, 6, 7]) and ts[0] is lanes


@pytest.fixture(scope="module")
def chain130():
    jchain = make_light_chain(3, n_vals=130, seed=b"mesh")
    sets = {}
    return jchain, [port_block(lb, sets) for lb in jchain]


def _counts(fn):
    _build.reset_launches()
    tbatch.DISPATCHES.clear()
    fn()
    return dict(tbatch.DISPATCHES), dict(_build.PLAIN_CALLS)


def test_one_sharded_dispatch_per_verify_commit(chain130):
    """Under a device set of four, ``VerifyCommit`` at 130 lanes takes one
    ``rlc_gather_sharded`` dispatch: one sums call for the four shards of
    the one device, one combine, no single-device verdict.  A tampered
    lane adds one ``gather_sharded`` dispatch that names it, as the JAX
    package does."""
    jchain, tchain = chain130
    plan.set_devices(["cpu"] * 4)
    lb = tchain[1]
    disp, plain = _counts(lambda: TV.VerifyCommit(
        "light-chain", lb.validators, lb.commit.block_id, lb.height,
        lb.commit))
    assert disp == {"rlc_gather_sharded": 1}
    assert plain.get("ed25519_rlc_sums") == 1
    assert plain.get("ed25519_rlc_combine") == 1
    assert "ed25519_rlc_gather" not in plain
    assert "ed25519_verify_gather" not in plain
    bad = 77
    tc = copy.deepcopy(lb.commit)
    sig = bytearray(tc.signatures[bad].signature)
    sig[5] ^= 1
    tc.signatures[bad].signature = bytes(sig)
    jc = copy.deepcopy(jchain[1].commit)
    jc.signatures[bad].signature = bytes(sig)
    with pytest.raises(JV.ErrInvalidSignature) as je:
        JV.VerifyCommit("light-chain", jchain[1].validators, jc.block_id,
                        jc.height, jc, backend="cpu")

    def tampered():
        with pytest.raises(TV.ErrInvalidSignature) as te:
            TV.VerifyCommit("light-chain", lb.validators, tc.block_id,
                            lb.height, tc)
        assert te.value.idx == je.value.idx == bad

    disp, plain = _counts(tampered)
    assert disp == {"rlc_gather_sharded": 1, "gather_sharded": 1}
    assert plain.get("ed25519_verify_gather") == 4
    # below rlc_min_lanes (the light scope of 87 lanes): per lane only
    disp, _ = _counts(lambda: TV.VerifyCommitLight(
        "light-chain", lb.validators, lb.commit.block_id, lb.height,
        lb.commit))
    assert disp == {"gather_sharded": 1}


def test_sharded_localisation_matches_jax_batched(chain130):
    """``verify_commits_light_batched`` over two commits (174 lanes) under
    a device set of three, with a bad lane in the second commit: the
    sharded RLC rejects, the sharded per-lane kernel names the same
    item, height and lane as the JAX package."""
    jchain, tchain = chain130
    plan.set_devices(["cpu"] * 3)
    bad = 40
    jc = copy.deepcopy(jchain[2].commit)
    tc = copy.deepcopy(tchain[2].commit)
    sig = bytearray(jc.signatures[bad].signature)
    sig[50] ^= 4
    jc.signatures[bad].signature = tc.signatures[bad].signature = bytes(sig)
    jitems = [(jchain[1].commit.block_id, 2, jchain[1].commit),
              (jc.block_id, 3, jc)]
    titems = [(tchain[1].commit.block_id, 2, tchain[1].commit),
              (tc.block_id, 3, tc)]
    with pytest.raises(JV.ErrBatchItemInvalid) as je:
        JV.verify_commits_light_batched("light-chain", jchain[1].validators,
                                        jitems, backend="cpu")
    tbatch.DISPATCHES.clear()
    with pytest.raises(TV.ErrBatchItemInvalid) as te:
        TV.verify_commits_light_batched("light-chain", tchain[1].validators,
                                        titems)
    assert (te.value.item, te.value.height, te.value.cause.idx) == \
        (je.value.item, je.value.height, je.value.cause.idx) == (1, 3, bad)
    assert dict(tbatch.DISPATCHES) == {"rlc_gather_sharded": 1,
                                       "gather_sharded": 1}
    assert TV.verify_commits_light_batched(
        "light-chain", tchain[1].validators, titems[:1]) == 87


@pytest.mark.parametrize("devices", [
    ("cpu",) * 3, ("cpu",) * 32, tuple(torch.device("cpu", i)
                                       for i in range(5))],
    ids=["3", "32", "5 distinct"])
def test_sharded_per_lane_kinds_equal_unsharded(jax_fns, devices):
    """The per-lane routes (``gather``: through a table; ``verify``:
    through each shard's own keys) over ragged and empty shards give the
    single-device verdicts in lane order."""
    both = Both(jax_fns, 2, 130)
    args = both.torch_args()[:-1]
    want = ted.verify_padded_gather(*args)
    pubs = torch.from_numpy(both.b.pubs[both.b.idx].copy())
    assert want.tolist() == both.b.oracle()
    devs = tuple(torch.device(d) for d in devices)
    assert torch.equal(tbatch._per_lane_sharded(devs, args[:3], args[3:]),
                       want)
    assert torch.equal(tbatch._per_lane_sharded(devs, (pubs,), args[3:]),
                       want)


def test_table_cache_holds_sets_over_distinct_devices(chain130):
    """Over eight distinct devices (indexed CPU devices, so the plain
    versions) a set's table is built once per device, and two sets
    alternate without a rebuild: the cache holds TABLE_CACHE_ENTRIES
    sets, each with its replicas, and evicts the oldest set."""
    _, tchain = chain130
    devices = [torch.device("cpu", i) for i in range(8)]
    rng = np.random.default_rng(140)
    sets = [rng.integers(0, 256, (4, 32), dtype=np.uint8)
            for _ in range(tbatch.TABLE_CACHE_ENTRIES + 1)]
    tbatch._TABLES.clear()
    _build.reset_launches()
    for _ in range(3):
        for pubs in sets[:2]:
            assert list(tbatch._valset_tables(pubs, devices)) == devices
    assert _build.PLAIN_CALLS["ed25519_tables"] == 2 * 8
    for pubs in sets[2:]:
        tbatch._valset_tables(pubs, devices[:1])
    assert _build.PLAIN_CALLS["ed25519_tables"] == 2 * 8 + 3
    assert id(sets[0]) not in tbatch._TABLES
    tbatch._valset_tables(sets[1], devices)
    assert _build.PLAIN_CALLS["ed25519_tables"] == 2 * 8 + 3
    lb = tchain[1]
    plan.set_devices(devices)
    builds = []
    for _ in range(2):
        disp, plain = _counts(lambda: TV.VerifyCommit(
            "light-chain", lb.validators, lb.commit.block_id, lb.height,
            lb.commit))
        assert disp == {"rlc_gather_sharded": 1}
        assert plain["ed25519_rlc_sums"] == 8
        builds.append(plain.get("ed25519_tables", 0))
    assert builds == [8, 0]
    tbatch._TABLES.clear()


def test_device_set_reaches_every_entry_point(chain130):
    """``device=None`` under a device set: the batch verifier does not pin
    one device, and the merkle kernel route (2,100 leaves) runs on the
    set's first device (here CPU shards, so the plain versions)."""
    _, tchain = chain130
    lb = tchain[0]
    with pytest.raises(RuntimeError):           # no card, no set
        tbatch.create_batch_verifier()
    plan.set_devices(["cpu"] * 2)
    bv = tbatch.create_batch_verifier()
    for i in range(3):
        val = lb.validators.get_by_index(i)
        bv.add(val.pub_key, lb.commit.vote_sign_bytes("light-chain", i),
               lb.commit.signatures[i].signature)
    assert bv.verify() == (True, [True] * 3)
    assert tbatch.DISPATCHES == {"verify_sharded": 1}   # the lanes' keys
    _, tvals = _random_set(2100, 64)
    _build.reset_launches()
    assert tvals.hash() == tvals.hash("cpu")
    assert _build.PLAIN_CALLS["merkle_tree_leaves"] == 2
    assert not _build.LAUNCHES
