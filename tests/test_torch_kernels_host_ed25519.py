"""The host kernel harness (``tests/torch_kernels_host_fixtures.py``) on
the Ed25519 kernels: the table kernel, the per-lane ladder, the RLC
verdict's lane, window, comb and ladder launches, and the sharded
verdict's sums and combine, each against its plain PyTorch version (and
the oracle's verdicts), exactly."""

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto.batch import _padded_lane_args
from cometbft_tpu_torch.ops import ed25519 as ted
from cometbft_tpu_torch.ops import fe
from cometbft_tpu_torch.ops import rlc as trlc

from torch_kernels_host_fixtures import L, P, harness, needs_gxx  # noqa: F401

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = [pytest.mark.timeout(900), needs_gxx]


def _signed_lanes(n, n_keys, seed, lens=None):
    """n signed lanes over n_keys keys, messages of random lengths below
    150 bytes or of the lengths ``lens``."""
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n_keys)]
    pks = [ref.public_key_from_seed(s) for s in seeds]
    lanes = []
    for i in range(n):
        m = rng.bytes(int(rng.integers(0, 150)) if lens is None
                      else int(lens[i]))
        lanes.append((pks[i % n_keys], m, ref.sign(seeds[i % n_keys], m)))
    return lanes


def _torsion8(rng):
    while True:
        pt = ref.pt_decompress_zip215(rng.bytes(32))
        if pt is None:
            continue
        t = ref.pt_mul(L, pt)
        if not ref.pt_equal(t, ref.IDENTITY) and \
           not ref.pt_equal(ref.pt_mul(4, t), ref.IDENTITY):
            return t


def _non_square(rng):
    while True:
        cand = bytearray(rng.bytes(32))
        cand[31] &= 127
        if ref.pt_decompress_zip215(bytes(cand)) is None:
            return bytes(cand)


def _edge_lanes(rng):
    """ZIP-215-valid torsion lanes: a mixed-order key, the non-canonical
    identity key with R = [r]B and S = r, and the same key with a
    small-order R and S = 0."""
    t8 = _torsion8(rng)
    h0 = hashlib.sha512(rng.bytes(32)).digest()
    a_sc = ref._clamp(h0[:32])
    mixed = ref.pt_compress(ref.pt_add(ref.pt_mul(a_sc, ref.BASE), t8))
    m = rng.bytes(50)
    r_sc = ref.sc_reduce64(hashlib.sha512(h0[32:] + m).digest())
    r_enc = ref.pt_compress(ref.pt_mul(r_sc, ref.BASE))
    k_sc = ref.sc_reduce64(hashlib.sha512(r_enc + mixed + m).digest())
    ident = (1 + P).to_bytes(32, "little")
    r2 = int.from_bytes(rng.bytes(32), "little") % L
    return [
        (mixed, m, r_enc + ((r_sc + k_sc * a_sc) % L).to_bytes(32, "little")),
        (ident, b"whatever", ref.pt_compress(ref.pt_mul(r2, ref.BASE))
         + r2.to_bytes(32, "little")),
        (ident, b"x", ref.pt_compress(t8) + bytes(32)),
    ]


def _tampered(lanes, rng):
    """Bad lanes at the front: S flip, R flip, message, wrong key,
    S >= L, non-square A, non-square R."""
    lanes = list(lanes)
    pk, m, s = lanes[1]
    lanes[1] = (pk, m, s[:40] + bytes([s[40] ^ 1]) + s[41:])
    pk, m, s = lanes[2]
    lanes[2] = (pk, m, bytes([s[0] ^ 4]) + s[1:])
    pk, m, s = lanes[3]
    lanes[3] = (pk, m + b"!", s)
    lanes[4] = (lanes[5][0], lanes[4][1], lanes[4][2])
    pk, m, s = lanes[6]
    s_big = (int.from_bytes(s[32:], "little") + L).to_bytes(32, "little")
    lanes[6] = (pk, m, s[:32] + s_big)
    lanes[7] = (_non_square(rng), lanes[7][1], lanes[7][2])
    pk, m, s = lanes[8]
    lanes[8] = (pk, m, _non_square(rng) + s[32:])
    return lanes


class Lanes:
    """Lanes as the kernels take them: a table over the distinct keys,
    indices into it, and the packed R || A || M blocks."""

    def __init__(self, lanes):
        keys = []
        for pk, _, _ in lanes:
            if pk not in keys:
                keys.append(pk)
        self.lanes = lanes
        self.pubs = np.stack([np.frombuffer(k, np.uint8) for k in keys])
        self.idx = np.array([keys.index(pk) for pk, _, _ in lanes], np.int32)
        maxlen = max(max(len(m) for _, m, _ in lanes), 1)
        msgs = np.zeros((len(lanes), maxlen), np.uint8)
        for i, (_, m, _) in enumerate(lanes):
            msgs[i, :len(m)] = np.frombuffer(m, np.uint8)
        lens = np.array([len(m) for _, m, _ in lanes], np.int64)
        sigs = np.stack([np.frombuffer(s, np.uint8) for _, _, s in lanes])
        self.rb, self.sb, self.blocks, self.active = _padded_lane_args(
            self.pubs[self.idx], sigs[:, :32], sigs[:, 32:], msgs, lens,
            "cpu")
        self.tab, self.ok = ted.prepare_pubkey_tables(
            torch.from_numpy(self.pubs.copy()))

    def args(self):
        return (self.tab, self.ok, torch.from_numpy(self.idx.copy()),
                self.rb, self.sb, self.blocks, self.active)

    def host_inputs(self):
        return {"tab": self.tab.numpy(), "ok_a": self.ok.numpy().view(np.uint8),
                "idx": self.idx, "rb": self.rb.numpy(), "sb": self.sb.numpy(),
                "blocks": self.blocks.numpy(), "active": self.active.numpy()}

    def sizes(self):
        return (len(self.lanes), self.blocks.shape[1], self.pubs.shape[0])

    def oracle(self):
        return [ref.verify_zip215(pk, m, s) for pk, m, s in self.lanes]


def _point(c):
    """A cached (Y+X, Y-X, 2Z, 2dT) limb row of 40 -> affine (x, y)."""
    ypx, ymx, z2 = (fe.int_from_limbs([int(v) for v in c[k:k + 10]])
                    for k in (0, 10, 20))
    zi = pow(z2, P - 2, P)
    return ((ypx - ymx) * zi % P, (ypx + ymx) * zi % P)


@pytest.mark.parametrize("lpb", [16, 32])
@pytest.mark.parametrize("n", [1, 15, 17, 33, 300])
def test_tables_match_plain(harness, n, lpb):
    """The table kernel's lane layout (``lpb`` validators a block of 64
    threads, a ragged last block) over ``n`` keys: multiples of B and
    the ZIP-215 edge keys (y = p + 1, x = 0 with the sign bit, a torsion
    point, zero, all ones, and a non-square, which fails) spread over the
    blocks (one key: the non-square).  Rows equal the plain version's mod
    p, ok bits exactly."""
    rng = np.random.default_rng(31)
    encs = [ref.pt_compress(ref.pt_mul(int(rng.integers(1, 1 << 62)),
                                       ref.BASE)) for _ in range(n)]
    edges = [(1 + P).to_bytes(32, "little"),
             (1 | (1 << 255)).to_bytes(32, "little"),
             ref.pt_compress(_torsion8(rng)), bytes(32), b"\xff" * 32,
             _non_square(rng)]
    for j, e in enumerate(edges):
        encs[(37 * j) % n] = e
    pub = np.stack([np.frombuffer(e, np.uint8) for e in encs])
    got = harness("tables", [n, lpb], {"pub": pub},
                  {"tab": (np.int32, (n, 16, 4, 10)), "ok": (np.uint8, (n,))})
    tab, ok = ted._prepare_plain(torch.from_numpy(pub))
    assert got["ok"].astype(bool).tolist() == ok.tolist()
    assert not ok.all()
    assert torch.equal(ted.tables_canonical(torch.from_numpy(got["tab"])),
                       ted.tables_canonical(tab))


def test_verify_gather_matches_plain_and_oracle(harness):
    rng = np.random.default_rng(33)
    lanes = _tampered(_signed_lanes(40, 12, 33), rng)
    lanes[9:12] = _edge_lanes(rng)
    b = Lanes(lanes)
    n_lanes, nb, n = b.sizes()
    got = harness("verify", [n_lanes, nb, n], b.host_inputs(),
                  {"out": (np.uint8, (n_lanes,))})["out"].astype(bool)
    plain = ted._verify_gather_plain(*b.args())
    want = b.oracle()
    assert got.tolist() == plain.tolist() == want
    assert not all(want) and sum(want) > 30


def _rlc_case(name):
    rng = np.random.default_rng(34)
    if name == "valid, 3 blocks":
        return Lanes(_signed_lanes(300, 40, 34)), None, True
    if name == "garbage padding, 3 blocks":
        lanes = _signed_lanes(300, 40, 35)
        for i in range(280, 300):
            pk, m, _ = lanes[i]
            lanes[i] = (pk, m, b"\xff" * 64)
        return Lanes(lanes), np.arange(300) < 280, True
    if name == "tampered":
        return Lanes(_tampered(_signed_lanes(40, 12, 36), rng)), None, False
    if name == "torsion edges":
        lanes = _signed_lanes(40, 12, 37)
        lanes[:3] = _edge_lanes(rng)
        return Lanes(lanes), None, True
    raise KeyError(name)


@pytest.mark.parametrize("name", ["valid, 3 blocks",
                                  "garbage padding, 3 blocks", "tampered",
                                  "torsion edges"])
def test_rlc_gather_matches_plain(harness, name):
    """The verdict and the 96 window sums (three blocks of partials per
    window in the larger cases, folded per thread before the tree)."""
    b, active_mask, expect = _rlc_case(name)
    n_lanes, nb, n = b.sizes()
    z = trlc.host_rlc_coeffs(n_lanes, active_mask,
                             rng_bytes=np.random.default_rng(38).bytes(
                                 16 * n_lanes))
    got = harness("rlc", [n_lanes, nb, n, trlc.lane_block(n_lanes)],
                  {**b.host_inputs(), "z": z},
                  {"out": (np.uint8, (1,)), "sums": (np.int32, (96, 40))})
    args = (*b.args(), torch.from_numpy(z))
    assert bool(got["out"][0]) == bool(trlc._rlc_plain(*args)) == expect
    sum_a, sum_r, _, _ = trlc._rlc_sums_plain(*args)
    plain = [torch.cat([c[:, w] for c in sum_a]).tolist() for w in range(64)]
    plain += [torch.cat([c[:, w] for c in sum_r]).tolist() for w in range(32)]
    want = [_point(c) for c in plain]
    assert [_point(c) for c in got["sums"]] == want


@pytest.mark.parametrize("n", [1, 3, 127, 129, 300])
def test_ragged_lanes_match_plain(harness, n):
    """Lane counts at the edges of the kernels' thread mappings (the
    per-lane kernel's 32 lanes of four threads a block, the lane stage's
    16 and 32 lanes a block, the window stage's 128 threads): the first lane a
    ZIP-215 torsion edge (a mixed-order key), the last one tampered (with
    one lane, the edge lane tampered).  The per-lane verdicts against the
    plain version and the oracle; the RLC verdict and the 96 window sums
    against the plain version, with the tampered lane active (the lane
    stage at 16 lanes a block) and then as padding, z = 0 (at 32 lanes a
    block)."""
    rng = np.random.default_rng(80 + n)
    lanes = _signed_lanes(n, min(n, 12), 80 + n)
    lanes[0] = _edge_lanes(rng)[0]
    pk, m, sig = lanes[n - 1]
    lanes[n - 1] = (pk, m, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
    b = Lanes(lanes)
    n_lanes, nb, n_keys = b.sizes()
    got = harness("verify", [n_lanes, nb, n_keys], b.host_inputs(),
                  {"out": (np.uint8, (n_lanes,))})["out"].astype(bool)
    plain = ted._verify_gather_plain(*b.args())
    want = b.oracle()
    assert got.tolist() == plain.tolist() == want
    assert want == [i != n - 1 for i in range(n)]
    for pad, lpb in ((None, 16), (np.arange(n) != n - 1, 32)):
        z = trlc.host_rlc_coeffs(n, pad, rng_bytes=rng.bytes(16 * n))
        got = harness("rlc", [n_lanes, nb, n_keys, lpb],
                      {**b.host_inputs(), "z": z},
                      {"out": (np.uint8, (1,)), "sums": (np.int32, (96, 40))})
        args = (*b.args(), torch.from_numpy(z))
        assert bool(got["out"][0]) == bool(trlc._rlc_plain(*args)) == \
            (pad is not None)
        sum_a, sum_r, _, _ = trlc._rlc_sums_plain(*args)
        rows = [torch.cat([c[:, w] for c in sum_a]).tolist()
                for w in range(64)]
        rows += [torch.cat([c[:, w] for c in sum_r]).tolist()
                 for w in range(32)]
        assert [_point(c) for c in got["sums"]] == [_point(c) for c in rows]


@pytest.mark.parametrize("case", ["padding active 0", "active cut short"])
@pytest.mark.parametrize("lpb", [16, 32])
def test_ragged_blocks_match_plain(harness, lpb, case):
    """The lane stage's hash over lanes of one, two and three SHA-512
    blocks in one batch (NB = 3: messages of 0-47, 48-175 and 176-303
    bytes after R || A), hashed in the warp of each block that does not
    decode, ``lpb`` lanes a block: with a padding lane (z = 0) whose
    active count is 0, an accept; with a three-block lane's count cut to
    two, a reject (h is then the digest of its first two blocks).  The
    verdict and the 96 window sums against the plain version, which masks
    the blocks the same way."""
    rng = np.random.default_rng(120 + lpb)
    n = 40
    spans = ((0, 48), (48, 176), (176, 304))
    lens = [int(rng.integers(*spans[i % 3])) for i in range(n)]
    b = Lanes(_signed_lanes(n, 7, 120 + lpb, lens))
    n_lanes, nb, n_keys = b.sizes()
    active = b.active.numpy().copy()
    assert nb == 3 and sorted(set(active.tolist())) == [1, 2, 3]
    mask = None
    if case == "padding active 0":
        mask = np.arange(n) != 5
        active[5] = 0
    else:
        active[int(np.flatnonzero(active == 3)[0])] = 2
    z = trlc.host_rlc_coeffs(n, mask, rng_bytes=rng.bytes(16 * n))
    got = harness("rlc", [n_lanes, nb, n_keys, lpb],
                  {**b.host_inputs(), "active": active, "z": z},
                  {"out": (np.uint8, (1,)), "sums": (np.int32, (96, 40))})
    args = (*b.args()[:6], torch.from_numpy(active), torch.from_numpy(z))
    assert bool(got["out"][0]) == bool(trlc._rlc_plain(*args)) == \
        (case == "padding active 0")
    sum_a, sum_r, _, _ = trlc._rlc_sums_plain(*args)
    rows = [torch.cat([c[:, w] for c in sum_a]).tolist() for w in range(64)]
    rows += [torch.cat([c[:, w] for c in sum_r]).tolist() for w in range(32)]
    assert [_point(c) for c in got["sums"]] == [_point(c) for c in rows]


def _cached_row(pt):
    """The oracle's extended point -> a cached row of 40 limbs."""
    zi = pow(pt[2], P - 2, P)
    x, y = pt[0] * zi % P, pt[1] * zi % P
    return sum((fe.limbs_from_int(v) for v in
                (y + x, y - x, 2, 2 * ref.D * x * y)), [])


@pytest.mark.parametrize("name", ["identity", "small order", "balanced",
                                  "unbalanced", "balanced, lane veto"])
def test_ladder_windows_match_plain(harness, name):
    """The verdict's last stages on chosen window sums: the single-device
    verdict's comb and ladder launches, and the combine entry over one
    shard, against the plain combine and the expected verdict.  The
    windows hold the identity and small-order points (orders 8, 4 and 2,
    which the cofactor clears); "balanced" sets A window 0 to
    T - [s]B for the sum s, "unbalanced" uses s + 1 for the sum, and the
    last case clears the ok byte."""
    rng = np.random.default_rng(90)
    t8 = _torsion8(rng)
    rows = [_cached_row(ref.IDENTITY)] * 96
    rows[5] = _cached_row(t8)
    rows[64 + 3] = _cached_row(ref.pt_mul(2, t8))
    rows[63] = _cached_row(ref.pt_mul(4, t8))
    rows[64 + 31] = _cached_row(ref.pt_mul(3, t8))
    s_int, ok = 0, 1
    if name != "identity" and name != "small order":
        s_int = int.from_bytes(rng.bytes(32), "little") % L
        neg_sb = ref.pt_mul(L - s_int, ref.BASE)
        rows[0] = _cached_row(ref.pt_add(neg_sb, t8))
    if name == "unbalanced":
        s_int = (s_int + 1) % L
    if name == "balanced, lane veto":
        ok = 0
    if name == "identity":
        rows = [_cached_row(ref.IDENTITY)] * 96
    sums = np.array(rows, np.int32)
    zs = np.frombuffer(s_int.to_bytes(32, "little"), np.uint8)
    okb = np.array([ok], np.uint8)
    got = harness("ladder", [1], {"sums": sums, "zs": zs, "ok": okb},
                  {"out": (np.uint8, (2,))})["out"]
    plain = bool(trlc._rlc_combine_plain(
        torch.from_numpy(sums[None]), torch.from_numpy(zs[None].copy()),
        torch.from_numpy(okb)))
    expect = name in ("identity", "small order", "balanced")
    assert [bool(v) for v in got] == [plain, plain] == [expect, expect]


@pytest.mark.parametrize("d,n_lanes,tamper,cards,lpb", [
    (1, 9, None, 1, 16), (3, 10, 9, 1, 32), (4, 9, 4, 1, 16),
    (4, 300, 150, 2, 32), (2, 300, None, 1, 16)],
    ids=["D1", "D3-ragged-tampered", "D4-empty-shard-tampered",
         "D4-two-cards-tampered", "D2-300"])
def test_rlc_sharded_matches_plain(harness, d, n_lanes, tamper, cards, lpb):
    """The sharded verdict: per card one ``ed25519_rlc_sums`` call over
    its shards' lanes (the lane stage hashing them), each shard into its
    slot, then ``ed25519_rlc_combine``, against
    ``make_verify_batch_rlc_sharded`` over ``d`` CPU shards: the verdict,
    each shard's window sums as points, its sum z*s mod L and its ok
    byte.  Shards are ``ceil(B / d)`` lanes, so 10 lanes over 3 end in a
    short shard and 9 lanes over 4 in an empty one; over two cards,
    shard d lies on card d % 2, so a card's shards are not side by side
    in the batch.  The harness lets a pass of the sums call take two
    shards, so three or four shards of one card take two passes (the
    second holds the tampered lane of D3 and the empty shard of D4).
    The lane stage runs at ``lpb`` lanes a block."""
    from cometbft_tpu_torch.parallel.mesh import batch_mesh, shard_bounds

    rng = np.random.default_rng(70 + d + n_lanes)
    lanes = _signed_lanes(n_lanes, 5, 70 + n_lanes)
    if tamper is not None:
        pk, m, s = lanes[tamper]
        lanes[tamper] = (pk, m, s[:40] + bytes([s[40] ^ 1]) + s[41:])
    b = Lanes(lanes)
    _, nb, n = b.sizes()
    z = trlc.host_rlc_coeffs(n_lanes, rng_bytes=rng.bytes(16 * n_lanes))
    got = harness("rlc_sharded", [n_lanes, nb, n, d, cards, lpb],
                  {**b.host_inputs(), "z": z},
                  {"out": (np.uint8, (1,)),
                   "sums": (np.int32, (d, 96, 40)),
                   "zs": (np.uint8, (d, 32)), "ok": (np.uint8, (d,))})
    args = (*b.args(), torch.from_numpy(z))
    fn = trlc.make_verify_batch_rlc_sharded(batch_mesh(["cpu"] * d),
                                            gather=True)
    expect = tamper is None
    assert bool(got["out"][0]) == bool(fn(*args)) == expect
    assert bool(trlc.verify_batch_rlc_gather(*args)) == expect
    for s, (lo, hi) in enumerate(shard_bounds(n_lanes, d)):
        part = trlc.rlc_sums_gather(*[a[lo:hi] if i >= 2 else a
                                      for i, a in enumerate(args)])
        assert [_point(c) for c in got["sums"][s]] == \
            [_point(c) for c in part.sums[0].numpy()]
        assert got["zs"][s].tolist() == part.zs[0].tolist()
        assert got["ok"][s] == part.ok[0]
    # an empty shard exactly where the first d - 1 shards take every lane
    assert any(lo == hi for lo, hi in shard_bounds(n_lanes, d)) == \
        (-(-n_lanes // d) * (d - 1) >= n_lanes)
