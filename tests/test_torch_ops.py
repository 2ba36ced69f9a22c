"""The port's plain PyTorch ops against the JAX package, exactly.

Same inputs, made from a seed with numpy, go through ``jax.jit`` of the
JAX function and through the port's plain version (the version its
kernel wrappers run on CPU tensors).  Everything is integers, digests
and booleans, so the tolerance is zero: field elements compare after
reduction mod p, scalars mod L, verdicts and digests bit for bit."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_py as jref
from cometbft_tpu.ops import ed25519 as jed
from cometbft_tpu.ops import fe as jfe
from cometbft_tpu.ops import scalar as jscalar
from cometbft_tpu.ops import sha512 as jsha
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import _ed25519_py as tref
from cometbft_tpu_torch.device import resolve_device
from cometbft_tpu_torch.ops import _build, fe, group, scalar, sha512
from cometbft_tpu_torch.ops import ed25519 as ted

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

P, L = jfe.P_INT, jscalar.L_INT
LANES = 16


def _t(a, dtype=None):
    a = np.array(a)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


def _msgs_blocks(rng, lanes=LANES, nb=2):
    lens = rng.integers(0, nb * 128 - 17, size=lanes)
    lens[:3] = [0, 111, nb * 128 - 17]
    msgs = np.zeros((lanes, nb * 128), np.uint8)
    for i, n in enumerate(lens):
        msgs[i, :n] = np.frombuffer(rng.bytes(int(n)), np.uint8)
    return msgs, lens


def test_host_pad_copy_matches_jax():
    rng = np.random.default_rng(1)
    msgs, lens = _msgs_blocks(rng)
    jb, ja = jsha.host_pad(msgs, lens, 2)
    tb, ta = sha512.host_pad(msgs, lens, 2)
    assert np.array_equal(jb, tb) and np.array_equal(ja, ta)
    assert sha512.max_blocks_for_len(111) == jsha.max_blocks_for_len(111)


def test_sha512_blocks_matches_jax_and_hashlib():
    rng = np.random.default_rng(2)
    msgs, lens = _msgs_blocks(rng)
    blocks, active = jsha.host_pad(msgs, lens, 2)
    want = np.asarray(jax.jit(jsha.sha512_blocks)(blocks, active))
    got = sha512.sha512_blocks(_t(blocks.view(np.int32)), _t(active)).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    for i in range(LANES):
        assert bytes(got[i].astype(np.uint8)) == hashlib.sha512(
            msgs[i, :lens[i]].tobytes()).digest()


def test_sha512_scalar_plain_is_digest_mod_l():
    rng = np.random.default_rng(3)
    msgs, lens = _msgs_blocks(rng)
    blocks, active = sha512.host_pad(msgs, lens, 2)
    h = sha512.sha512_scalar(_t(blocks.view(np.int32)), _t(active))
    assert h.dtype == torch.uint8 and h.shape == (LANES, 32)
    for i in range(LANES):
        d = hashlib.sha512(msgs[i, :lens[i]].tobytes()).digest()
        assert int.from_bytes(bytes(h[i].tolist()), "little") == \
            int.from_bytes(d, "little") % L


def _scalar_inputs(rng):
    dig = np.frombuffer(rng.bytes(64 * LANES), np.uint8).reshape(LANES, 64)
    dig = dig.copy()
    dig[0] = 0xFF
    dig[1] = 0
    s = np.frombuffer(rng.bytes(32 * LANES), np.uint8).reshape(LANES, 32)
    s = s.copy()
    for i, v in enumerate((L - 1, L, L + 1, 2**256 - 1, 0)):
        s[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    s[5:10, 31] &= 0x0F                # mostly canonical values below L
    return dig, s


def test_reduce512_matches_jax_mod_l():
    dig, _ = _scalar_inputs(np.random.default_rng(4))
    want = np.asarray(jax.jit(jscalar.reduce512)(dig.astype(np.int32)))
    got = scalar.reduce512(_t(dig))
    for i in range(LANES):
        w = jfe.int_from_limbs(want[i])
        g = scalar.int_from_limbs(got[i].tolist())
        assert g < L and g == w % L == int.from_bytes(dig[i].tobytes(),
                                                      "little") % L


def test_lt_l_matches_jax():
    _, s = _scalar_inputs(np.random.default_rng(5))
    want = np.asarray(jax.jit(lambda b: jscalar.lt_l(
        jscalar.bytes32_to_limbs(b)))(s.astype(np.int32)))
    got = scalar.lt_l(scalar.bytes32_to_limbs(_t(s))).numpy()
    assert np.array_equal(got, want)
    assert got[:4].tolist() == [True, False, False, False]


def test_mul_sum_mod_l_and_nibbles_match_jax():
    rng = np.random.default_rng(6)
    _, s = _scalar_inputs(rng)
    zb = np.frombuffer(rng.bytes(16 * LANES), np.uint8).reshape(LANES, 16)
    zi = [int.from_bytes(zb[i].tobytes(), "little") for i in range(LANES)]
    si = [int.from_bytes(s[i].tobytes(), "little") for i in range(LANES)]
    z10 = np.stack([jfe.limbs_from_int(v)[:jscalar.Z_NLIMBS]
                    for v in zi]).astype(np.int32)

    def jax_fn(b, z):
        prod = jscalar.mul_mod_l(jscalar.bytes32_to_limbs(b), z)
        return prod, jscalar.sum_mod_l(prod, axis=0), jscalar.nibbles(prod)

    jprod, jsum, jdig = [np.asarray(x) for x in jax.jit(jax_fn)(
        s.astype(np.int32), z10)]
    tprod = scalar.mul_mod_l(scalar.bytes32_to_limbs(_t(s)),
                             scalar.bytes_to_limbs(_t(zb), 7))
    tsum = scalar.sum_mod_l(tprod)
    tdig = scalar.nibbles(tprod).numpy()
    for i in range(LANES):
        g = scalar.int_from_limbs(tprod[i].tolist())
        assert g == jfe.int_from_limbs(jprod[i]) % L == si[i] * zi[i] % L
        # the port's digits spell its (fully reduced) value exactly
        assert sum(int(d) << (4 * k) for k, d in enumerate(tdig[i])) == g
        assert sum(int(d) << (4 * k) for k, d in enumerate(jdig[i])) % L == g
    assert scalar.int_from_limbs(tsum.tolist()) == \
        jfe.int_from_limbs(jsum) % L


def _edge_encodings(rng, n):
    """n encodings: random points, non-canonical y >= p, the x = 0 sign-bit
    identity, non-squares, and y = p - 1 (x = 0 other sign)."""
    encs = [(1 + P).to_bytes(32, "little"), (2 + P).to_bytes(32, "little"),
            (1 | (1 << 255)).to_bytes(32, "little"),
            (P - 1).to_bytes(32, "little"), (0).to_bytes(32, "little")]
    while sum(jref.pt_decompress_zip215(e) is None for e in encs) < 3:
        cand = bytearray(rng.bytes(32))
        cand[31] &= 127
        if jref.pt_decompress_zip215(bytes(cand)) is None:
            encs.append(bytes(cand))
    while len(encs) < n:
        seed = rng.bytes(32)
        encs.append(jref.public_key_from_seed(seed))
    return np.stack([np.frombuffer(e, np.uint8) for e in encs[:n]])


def test_decompress_zip215_matches_jax_and_oracle():
    encs = _edge_encodings(np.random.default_rng(7), LANES)
    jpt, jok = jax.jit(lambda e: jed._g.decompress_zip215(
        jax.numpy.transpose(e)))(encs.astype(np.int32))
    jok = np.asarray(jok)
    tpt, tok = group.decompress_zip215(_t(encs))
    assert np.array_equal(tok.numpy(), jok)
    for i in range(LANES):
        want = tref.pt_decompress_zip215(encs[i].tobytes())
        assert bool(tok[i]) == (want is not None)
        if want is None:
            continue
        for comp in ("x", "y"):
            j = jfe.int_from_limbs(np.asarray(getattr(jpt, comp))[:, i])
            t = fe.int_from_limbs(getattr(tpt, comp)[:, i].tolist())
            assert t == j % P == want["xy".index(comp)] % P


@pytest.mark.parametrize("op", ["dbl", "add_cached", "add_niels", "add_cc"])
def test_group_ops_match_oracle(op):
    rng = np.random.default_rng(8)
    pts = [tref.pt_mul(int.from_bytes(rng.bytes(32), "little"), tref.BASE)
           for _ in range(6)]
    encs = torch.tensor([list(tref.pt_compress(p)) for p in pts],
                        dtype=torch.uint8)
    p, ok = group.decompress_zip215(encs)
    q, _ = group.decompress_zip215(encs.flip(0))
    assert bool(ok.all())
    qc = group.cache(q)
    if op == "dbl":
        r = group.dbl(p)
        want = [tref.pt_double(a) for a in pts]
    elif op == "add_cc":
        c = group.add_cc(group.cache(p), qc)
        two = fe.const(group.INV2_INT, "cpu")
        r = group.Ext(fe.mul(fe.sub(c.ypx, c.ymx), two),
                      fe.mul(fe.add(c.ypx, c.ymx), two), fe.mul(c.z2, two),
                      p.t)
        want = [tref.pt_add(a, b) for a, b in zip(pts, pts[::-1])]
    else:
        if op == "add_niels":
            zi = fe.invert(q.z)
            x, y = fe.mul(q.x, zi), fe.mul(q.y, zi)
            qn = group.Niels(fe.add(y, x), fe.sub(y, x), fe.mul(
                fe.mul(x, y), fe.const(group.D2_INT, "cpu")))
            r = group.add_niels(p, qn)
        else:
            r = group.add_cached(p, qc)
        want = [tref.pt_add(a, b) for a, b in zip(pts, pts[::-1])]
    for i, w in enumerate(want):
        x, y, z = (fe.int_from_limbs(c[:, i].tolist()) for c in r[:3])
        zi = pow(z, P - 2, P)
        wzi = pow(w[2], P - 2, P)
        assert (x * zi % P, y * zi % P) == (w[0] * wzi % P, w[1] * wzi % P)


@pytest.mark.timeout(900)
def test_prepare_pubkey_tables_match_jax_and_convert_round_trips():
    encs = _edge_encodings(np.random.default_rng(9), LANES)
    jtab, jok = jax.jit(jed.prepare_pubkey_tables)(encs.astype(np.int32))
    ttab, tok = ted.prepare_pubkey_tables(_t(encs))
    assert ttab.shape == (LANES, 16, 4, 10) and ttab.dtype == torch.int32
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    ctab, cok = convert.tables_from_jax(*[np.asarray(c) for c in jtab],
                                        np.asarray(jok))
    assert torch.equal(cok, tok)
    live = tok.numpy()
    # every field element of every live row agrees mod p
    assert torch.equal(ted.tables_canonical(ttab)[live], ctab[live])
    # the converted table is already canonical: converting is idempotent
    assert torch.equal(ted.tables_canonical(ctab), ctab)
    # entry j of a live row is [j](-A): check j = 1 against the oracle
    for i in np.nonzero(live)[0][:4]:
        a = tref.pt_decompress_zip215(encs[i].tobytes())
        na = ((-a[0]) % P, a[1], 1, (-a[3]) % P)
        ypx = fe.int_from_limbs(ctab[i, 1, 0].tolist())
        assert ypx == (na[1] + na[0]) % P


def test_kernel_wrappers_check_their_arguments():
    with pytest.raises(TypeError):
        ted.prepare_pubkey_tables(torch.zeros((2, 32), dtype=torch.int32))
    with pytest.raises(ValueError):
        ted.prepare_pubkey_tables(torch.zeros((2, 31), dtype=torch.uint8))
    with pytest.raises(ValueError):
        sha512.sha512_scalar(torch.zeros((2, 1, 32), dtype=torch.int32)[:, :,
                                                                         ::2],
                             torch.zeros((2,), dtype=torch.int32))


@pytest.mark.parametrize("bad", [-1, 3, 7])
def test_gather_wrappers_refuse_rows_outside_the_table(bad):
    from cometbft_tpu_torch.ops import rlc

    tab = torch.zeros((3, 16, 4, 10), dtype=torch.int32)
    ok = torch.ones((3,), dtype=torch.bool)
    idx = torch.tensor([0, bad], dtype=torch.int32)
    rb = torch.zeros((2, 32), dtype=torch.uint8)
    blocks = torch.zeros((2, 1, 32), dtype=torch.int32)
    active = torch.ones((2,), dtype=torch.int32)
    _build.reset_launches()
    with pytest.raises(IndexError):
        ted.verify_padded_gather(tab, ok, idx, rb, rb, blocks, active)
    with pytest.raises(IndexError):
        rlc.verify_batch_rlc_gather(tab, ok, idx, rb, rb, blocks, active,
                                    torch.ones((2, 16), dtype=torch.uint8))
    with pytest.raises(IndexError):
        sha512.sha512_scalar(blocks, torch.tensor([1, bad],
                                                  dtype=torch.int32))
    assert not _build.PLAIN_CALLS and not _build.LAUNCHES


def test_cpu_tensors_run_the_plain_versions():
    _build.reset_launches()
    rng = np.random.default_rng(10)
    encs = _edge_encodings(rng, 4)
    ted.prepare_pubkey_tables(_t(encs))
    msgs, lens = _msgs_blocks(rng, lanes=4)
    blocks, active = sha512.host_pad(msgs, lens, 2)
    sha512.sha512_scalar(_t(blocks.view(np.int32)), _t(active))
    assert not _build.LAUNCHES
    assert _build.PLAIN_CALLS == {"ed25519_tables": 1, "sha512_scalar": 1}


def test_device_resolution(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_generated_constants_header():
    text = _build.consts_header()
    rows = ted.base_niels_rows()
    assert str(rows[1][0]).replace("[", "{").replace("]", "}") in text
    assert "c_sc_mu[6] = {666643LL, 470296LL, 654183LL, -997805LL, " \
        "136657LL, -683901LL}" in text
    assert all(name in _build.KERNELS for name in (
        "sha512_scalar", "ed25519_tables", "ed25519_verify_gather",
        "ed25519_rlc_gather"))
