"""The port's CUDA kernel sources, built for the host under the sanitizers.

``tests/torch_kernels_host.cpp`` includes the six sources of
``cometbft_tpu_torch/csrc`` as they are and runs each kernel and launch
sequence with host threads (a block's threads, a barrier for
``__syncthreads``).  It is compiled with ``g++ -fsanitize=address,
undefined``, so undefined behaviour in the device code (a signed
overflow, a shift out of range, a read out of bounds) stops the run.
What it computes must equal the plain PyTorch versions exactly: tables
and window sums as field elements mod p (sums as group elements, since
the two folds add in different orders), digests and verdicts bit for
bit.  The tolerance is zero."""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import _ed25519_py as ref
from cometbft_tpu_torch.crypto.batch import _padded_lane_args
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.ops import _build, blsg1, fe, sha256, sha512
from cometbft_tpu_torch.ops import ed25519 as ted
from cometbft_tpu_torch.ops import rlc as trlc

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = [
    pytest.mark.timeout(900),
    pytest.mark.skipif(shutil.which("g++") is None,
                       reason="needs g++ to build the kernel sources for "
                              "the host"),
]

HERE = Path(__file__).resolve().parent
L, P = ref.L, ref.P


def _confine():
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])
    os.nice(19)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    d = tmp_path_factory.mktemp("kernels_host")
    for name, text in _build.generated_headers().items():
        (d / name).write_text(text)
    exe = d / "torch_kernels_host"
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-fno-omit-frame-pointer", "-Wall",
         "-Werror", "-Wno-unknown-pragmas", "-pthread",
         "-I", str(_build.CSRC), "-I", str(d), "-o", str(exe),
         str(HERE / "torch_kernels_host.cpp")],
        check=True, capture_output=True)
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    count = [0]

    def run(mode, args, inputs, outputs):
        count[0] += 1
        io = d / f"call{count[0]}"
        io.mkdir()
        for name, a in inputs.items():
            np.ascontiguousarray(a).tofile(io / f"{name}.bin")
        # a block is up to 128 host threads that meet at barriers: two
        # CPUs at the lowest priority, so that other test processes do
        # not starve beside it
        proc = subprocess.run([str(exe), mode, str(io), *map(str, args)],
                              capture_output=True, text=True, env=env,
                              preexec_fn=_confine)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return {name: np.fromfile(io / f"{name}.bin", dtype).reshape(shape)
                for name, (dtype, shape) in outputs.items()}

    return run


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


def test_sha512_scalar_matches_plain_and_hashlib(harness):
    rng = np.random.default_rng(32)
    lens = np.array([0, 1, 111, 112, 127, 128, 17, 239], np.int64)
    msgs = np.zeros((len(lens), 240), np.uint8)
    for i, k in enumerate(lens):
        msgs[i, :k] = np.frombuffer(rng.bytes(int(k)), np.uint8)
    blocks, active = sha512.host_pad(msgs, lens, 2)
    b = len(lens)
    got = harness("sha", [b, 2], {"blocks": blocks, "active": active},
                  {"h": (np.uint8, (b, 32))})["h"]
    plain = sha512._sha512_scalar_plain(
        torch.from_numpy(blocks.view(np.int32).copy()),
        torch.from_numpy(active.copy()))
    assert np.array_equal(got, plain.numpy())
    for i, k in enumerate(lens):
        want = int.from_bytes(hashlib.sha512(msgs[i, :k].tobytes()).digest(),
                              "little") % L
        assert int.from_bytes(got[i].tobytes(), "little") == want


@pytest.mark.parametrize("words", [0, 1], ids=["bytes", "words"])
def test_sha256_leaves_match_plain_and_hashlib(harness, words):
    """Ragged one- and two-block leaves (55/56 and 119/120 bytes straddle
    the block edges), active counts outside [0, NB] acting as the mask's
    nearest end, at a lane count that leaves a partial thread block.  The
    kernel's digest words are held against both public wrappers' plain
    versions: ``sha256_blocks`` (bytes) and ``sha256_leaf_words``."""
    rng = np.random.default_rng(39)
    lens = np.array([0, 1, 55, 56, 63, 64, 100, 119] * 20 + [7, 9, 3],
                    np.int64)
    b, nb = len(lens), 2
    msgs = np.zeros((b, 120), np.uint8)
    for i, k in enumerate(lens):
        msgs[i, :k] = np.frombuffer(rng.bytes(int(k)), np.uint8)
    blocks, active = sha256.host_pad(msgs, lens, nb)
    active[-3:] = [-1, 0, 5]
    out = harness("sha256", [b, nb], {"blocks": blocks, "active": active},
                  {"out": (np.uint32, (b, 8))})["out"]
    got = sha256.words_to_bytes(out)
    args = (torch.from_numpy(blocks.view(np.int32).copy()),
            torch.from_numpy(active.copy()))
    if words:
        plain = sha256.sha256_leaf_words(*args).numpy()
        assert np.array_equal(out.view(np.int32), plain)
        plain = sha256.words_to_bytes(plain)
    else:
        plain = sha256.sha256_blocks(*args).numpy()
    assert np.array_equal(got, plain)
    empty = hashlib.sha256(b"").digest()
    for i, k in enumerate(lens[:-3]):
        assert got[i].tobytes() == hashlib.sha256(
            msgs[i, :k].tobytes()).digest()
    # active -1 and 0 leave the initial state; 5 runs both blocks
    iv = sha256.words_to_bytes(sha256.IV)
    assert got[-3].tobytes() == got[-2].tobytes() == iv.tobytes()
    assert got[-1].tobytes() != empty


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 600])
def test_merkle_tree_matches_plain_and_hashlib(harness, n):
    """Every level of trees around the kernel's runs of 256 children (one
    block, one block plus one child, three blocks and a second launch),
    against the plain level loop and against hashlib's level order."""
    from cometbft_tpu_torch.crypto import merkle

    rng = np.random.default_rng(50 + n)
    leaves = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32)
    words = sha256.bytes_to_words(leaves)
    rows = sha256.tree_rows(n)
    got = harness("merkle_tree", [n], {"leaves": words},
                  {"levels": (np.uint32, (rows, 8))})["levels"]
    buf = torch.zeros((rows, 8), dtype=torch.int32)
    buf[:n] = torch.from_numpy(words.view(np.int32))
    plain = sha256.merkle_tree(buf, n)
    assert np.array_equal(got.view(np.int32), plain.numpy())
    lv = [leaves[i].tobytes() for i in range(n)]
    want = []
    while True:
        want += lv
        if len(lv) == 1:
            break
        lv = [merkle.inner_hash(lv[2 * i], lv[2 * i + 1])
              for i in range(len(lv) // 2)] + lv[len(lv) - len(lv) % 2:]
    assert [r.tobytes() for r in sha256.words_to_bytes(got)] == want


@pytest.mark.parametrize("n", [2, 7, 257])
def test_merkle_level_matches_plain_and_hashlib(harness, n):
    rng = np.random.default_rng(40 + n)
    children = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32)
    words = sha256.bytes_to_words(children)
    m = (n + 1) // 2
    got = harness("merkle", [n], {"children": words},
                  {"parents": (np.uint32, (m, 8))})["parents"]
    plain = sha256.merkle_level(torch.from_numpy(words.view(np.int32)))
    assert np.array_equal(got.view(np.int32), plain.numpy())
    parents = sha256.words_to_bytes(got)
    for i in range(n // 2):
        assert parents[i].tobytes() == hashlib.sha256(
            b"\x01" + children[2 * i].tobytes()
            + children[2 * i + 1].tobytes()).digest()
    if n & 1:
        assert parents[-1].tobytes() == children[-1].tobytes()


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


@pytest.mark.parametrize("nb", ["1", "2", "mixed"])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 600])
def test_merkle_tree_leaves_matches_plain_and_hashlib(harness, n, nb):
    """The tree with its leaves in one call: the first launch hashes a run
    of 256 leaves a block (a thread a leaf) into the shared memory its
    subtree is built in, and writes them to the head of the level
    buffer.  One-block leaves (0x00 || up to 54
    bytes), two-block leaves (55 to 118 bytes), and a mix of both with
    active counts cut to 1, 0 and -1 and pushed past NB; every level
    against the plain version (the leaves' plain version, then the
    tree's) and hashlib's level order (the leaves' digests under the
    mask for the cut counts)."""
    from cometbft_tpu_torch.crypto import merkle

    rng = np.random.default_rng(130 + n)
    lo, hi = {"1": (0, 55), "2": (55, 119), "mixed": (0, 119)}[nb]
    items = [rng.bytes(int(k)) for k in rng.integers(lo, hi, size=n)]
    blocks, active = merkle._leaf_blocks(items)
    if nb == "mixed":
        active = active.copy()
        for i, a in zip(range(0, n, 7), (1, 0, -1, 3)):
            active[i] = a
    n_blocks = blocks.shape[1]
    rows = sha256.tree_rows(n)
    got = harness("merkle_tree_leaves", [n, n_blocks],
                  {"blocks": blocks, "active": active},
                  {"levels": (np.uint32, (rows, 8))})["levels"]
    plain = sha256.merkle_tree_leaves(
        torch.from_numpy(blocks.view(np.int32).copy()),
        torch.from_numpy(active))
    assert np.array_equal(got.view(np.int32), plain.numpy())
    # a leaf whose count covers its blocks is hashlib's digest, a count of
    # 0 or less the initial state; a count cut or pushed past its need
    # hashes other blocks and is held against the plain version alone
    iv = sha256.words_to_bytes(sha256.IV).tobytes()
    lv = []
    for i, it in enumerate(items):
        used = min(max(int(active[i]), 0), n_blocks)
        need = sha256.max_blocks_for_len(len(it) + 1)
        lv.append(iv if used == 0 else
                  merkle.leaf_hash(it) if used == need else
                  sha256.words_to_bytes(got[i]).tobytes())
    assert [sha256.words_to_bytes(r).tobytes() for r in got[:n]] == lv
    want = []
    while True:
        want += lv
        if len(lv) == 1:
            break
        lv = [merkle.inner_hash(lv[2 * i], lv[2 * i + 1])
              for i in range(len(lv) // 2)] + lv[len(lv) - len(lv) % 2:]
    assert [r.tobytes() for r in sha256.words_to_bytes(got)] == want


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


@pytest.mark.parametrize("r", [1, 5, 64, 300])
def test_blsg1_fold_matches_plain(harness, r):
    """The G1 fold's launches on the word table (the harness's blocks of
    8 rows: 5 rows in one launch, two additions at a time at the first
    level; 64 rows in two; 300 rows, padded to 512, in three, the later
    ones in place), against the plain version's (3, 32) projective limbs,
    exactly: all rows, a random mask, an empty mask, and from 5 rows a
    cancelling pair (row 0 and its negation) and a doubled point (row 1
    twice)."""
    rng = np.random.default_rng(60 + r)
    pts = [tbls.pk_to_affine(tbls.sk_to_pk(int(s)))
           for s in rng.integers(1, 1 << 62, size=r)]
    masks = [np.ones(r, np.int32), (rng.random(r) < 0.5).astype(np.int32),
             np.zeros(r, np.int32)]
    if r >= 5:
        pts[-1], pts[-2] = tbls.negate_affine(pts[0]), pts[1]
        cancel = np.zeros(r, np.int32)
        cancel[[0, r - 1]] = 1
        double = np.zeros(r, np.int32)
        double[[1, 2, r - 2]] = 1
        masks += [cancel, double]
    words = blsg1.words_from_limbs(torch.from_numpy(
        np.stack([blsg1.limbs_from_xy(p) for p in pts])))
    n2 = 1 << max(0, (r - 1).bit_length())
    for mask in masks:
        got = harness("blsg1", [r, n2], {"rows": words.numpy(),
                                          "mask": mask},
                      {"out": (np.int32, (3, 32))})["out"]
        plain = blsg1.g1_masked_sum(words, torch.from_numpy(mask))
        assert np.array_equal(got, plain.numpy())
        if not mask.any() or (r >= 5 and mask is masks[3]):
            assert blsg1.xy_from_projective(got) is None


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
