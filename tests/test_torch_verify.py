"""The port's per-lane and RLC verification against the JAX package.

``jax.jit(ed25519.verify_padded_gather)`` and
``jax.jit(rlc.verify_batch_rlc_gather)`` (compiled once each, at 16
lanes and 2 hash blocks, so one worker pays the compiles) against the
port's plain versions on the same numpy inputs, with the RLC
coefficients pinned through ``rng_bytes``.  Lanes cover the tamper
surfaces, padding lanes (valid and garbage), and the ZIP-215 edge cases
of ``tests/test_ed25519_kernel.py`` and ``tests/test_rlc.py``.  Verdicts
are booleans: the tolerance is zero."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_py as ref
from cometbft_tpu.ops import ed25519 as jed
from cometbft_tpu.ops import rlc as jrlc
from cometbft_tpu.ops import sha512 as jsha
from cometbft_tpu.testing import dense_signature_batch
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.ops import ed25519 as ted
from cometbft_tpu_torch.ops import rlc as trlc

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)

LANES, NB = 16, 2
L, P = ref.L, ref.P


def _torsion8(rng):
    while True:
        pt = ref.pt_decompress_zip215(rng.bytes(32))
        if pt is None:
            continue
        t = ref.pt_mul(ref.L, pt)
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
    """ZIP-215-valid torsion lanes: a mixed-order key signing over its
    mixed encoding, the non-canonical identity key with S = r, R = [r]B,
    and the same key with a small-order R and S = 0."""
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


class Batch:
    """16 lanes as both packages take them: a table over the distinct
    keys, scope indices, and padded R || A || M blocks."""

    def __init__(self, lanes):
        assert len(lanes) == LANES
        keys = []
        for pk, _, _ in lanes:
            if pk not in keys:
                keys.append(pk)
        self.lanes = lanes
        self.keys = keys + [keys[0]] * (LANES - len(keys))   # fixed N
        self.idx = np.array([keys.index(pk) for pk, _, _ in lanes], np.int32)
        hin = np.zeros((LANES, 64 + 96), np.uint8)
        lens = np.zeros((LANES,), np.int64)
        for i, (pk, m, s) in enumerate(lanes):
            full = s[:32] + pk + m
            hin[i, :len(full)] = np.frombuffer(full, np.uint8)
            lens[i] = len(full)
        self.blocks, self.active = jsha.host_pad(hin, lens, NB)
        self.pubs = np.stack([np.frombuffer(k, np.uint8) for k in self.keys])
        self.rb = np.stack([np.frombuffer(s[:32], np.uint8)
                            for _, _, s in lanes])
        self.sb = np.stack([np.frombuffer(s[32:], np.uint8)
                            for _, _, s in lanes])

    def oracle(self):
        return [ref.verify_zip215(pk, m, s) for pk, m, s in self.lanes]

    def jax_args(self):
        return (self.idx, self.rb.astype(np.int32), self.sb.astype(np.int32),
                self.blocks, self.active)

    def torch_args(self):
        t = torch.from_numpy
        return (t(self.idx.copy()), t(self.rb.copy()), t(self.sb.copy()),
                t(self.blocks.view(np.int32).copy()), t(self.active.copy()))


def _base_lanes(seed):
    """16 valid lanes over 12 keys from ``dense_signature_batch``."""
    args, items = dense_signature_batch(LANES, msg_len=80, seed=seed,
                                        n_keys=12)
    return [(pk, m, s) for pk, m, s in items]


@pytest.fixture(scope="module")
def jax_fns():
    return (jax.jit(jed.prepare_pubkey_tables),
            jax.jit(jed.verify_padded_gather),
            jax.jit(jrlc.verify_batch_rlc_gather))


def _tables(jax_fns, b):
    jtab, jok = jax_fns[0](b.pubs.astype(np.int32))
    ttab, tok = ted.prepare_pubkey_tables(torch.from_numpy(b.pubs.copy()))
    return (jtab, jok), (ttab, tok)


def _mixed_batch():
    rng = np.random.default_rng(21)
    lanes = _base_lanes(45)
    pk, m, s = lanes[1]
    lanes[1] = (pk, m, s[:40] + bytes([s[40] ^ 1]) + s[41:])     # S flip
    pk, m, s = lanes[2]
    lanes[2] = (pk, m, bytes([s[0] ^ 4]) + s[1:])                # R flip
    pk, m, s = lanes[3]
    lanes[3] = (pk, m + b"!", s)                                 # message
    lanes[4] = (lanes[5][0], lanes[4][1], lanes[4][2])           # wrong key
    pk, m, s = lanes[6]
    s_big = (int.from_bytes(s[32:], "little") + L).to_bytes(32, "little")
    lanes[6] = (pk, m, s[:32] + s_big)                           # S >= L
    lanes[7] = (_non_square(rng), lanes[7][1], lanes[7][2])      # bad A
    pk, m, s = lanes[8]
    lanes[8] = (pk, m, _non_square(rng) + s[32:])                # bad R
    lanes[9:12] = _edge_lanes(rng)
    return Batch(lanes)


def test_verify_padded_gather_matches_jax(jax_fns):
    b = _mixed_batch()
    want = b.oracle()
    assert want.count(False) == 7
    (jtab, jok), (ttab, tok) = _tables(jax_fns, b)
    jout = np.asarray(jax_fns[1](jtab, jok, *b.jax_args()))
    tout = ted.verify_padded_gather(ttab, tok, *b.torch_args()).numpy()
    assert jout.tolist() == tout.tolist() == want
    # the JAX package's own tables, carried over, give the same verdicts
    ctab, cok = convert.tables_from_jax(*[np.asarray(c) for c in jtab],
                                        np.asarray(jok), device="cpu")
    cout = ted.verify_padded_gather(ctab, cok, *b.torch_args()).numpy()
    assert cout.tolist() == want
    # the uncached twin over the lanes' own keys
    pubs = torch.from_numpy(np.stack([np.frombuffer(pk, np.uint8)
                                      for pk, _, _ in b.lanes]))
    uout = ted.verify_padded(pubs, *b.torch_args()[1:]).numpy()
    assert uout.tolist() == want


def _z(rng, active=None):
    raw = rng.bytes(16 * LANES)
    return (jrlc.host_rlc_coeffs(LANES, active_mask=active, rng_bytes=raw),
            trlc.host_rlc_coeffs(LANES, active_mask=active, rng_bytes=raw))


def test_host_rlc_coeffs_match_jax():
    rng = np.random.default_rng(22)
    active = np.arange(LANES) < 11
    raw = bytearray(rng.bytes(16 * LANES))
    raw[16 * 3:16 * 4] = bytes(16)                 # an active all-zero row
    j = jrlc.host_rlc_coeffs(LANES, active_mask=active, rng_bytes=bytes(raw))
    t = trlc.host_rlc_coeffs(LANES, active_mask=active, rng_bytes=bytes(raw))
    for i in range(LANES):
        zj = sum(int(v) << (13 * k) for k, v in enumerate(j[i]))
        assert zj == int.from_bytes(t[i].tobytes(), "little")
    assert int.from_bytes(t[3].tobytes(), "little") == 1
    assert not t[11:].any()


def _rlc_cases():
    """(name, Batch, active mask, expected verdict)."""
    rng = np.random.default_rng(23)
    valid = _base_lanes(46)
    valid[9:12] = _edge_lanes(rng)
    cases = [("valid with torsion lanes", Batch(valid), None, True)]
    for surface in ("s", "r", "a", "m"):
        lanes = list(valid)
        pk, m, s = lanes[5]
        if surface == "s":
            lanes[5] = (pk, m, s[:33] + bytes([s[33] ^ 1]) + s[34:])
        elif surface == "r":
            lanes[5] = (pk, m, bytes([s[0] ^ 1]) + s[1:])
        elif surface == "a":
            lanes[5] = (lanes[6][0], m, s)
        else:
            lanes[5] = (pk, m[:-1] + bytes([m[-1] ^ 1]), s)
        cases.append((f"tampered {surface}", Batch(lanes), None, False))
    garbage = list(valid)
    for i in (13, 14, 15):
        pk, m, _ = garbage[i]
        garbage[i] = (pk, m, b"\xff" * 64)
    active = np.arange(LANES) < 13
    cases.append(("garbage padding lanes", Batch(garbage), active, True))
    cases.append(("garbage active lanes", Batch(garbage), None, False))
    bad_pad = list(valid)
    pk, m, s = bad_pad[15]
    bad_pad[15] = (pk, m + b"?", s)
    cases.append(("invalid padding lane", Batch(bad_pad),
                  np.arange(LANES) < 15, True))
    return cases


@pytest.mark.parametrize("case", range(8))
def test_verify_batch_rlc_gather_matches_jax(jax_fns, case):
    name, b, active, expect = _rlc_cases()[case]
    rng = np.random.default_rng(100 + case)
    jz, tz = _z(rng, active)
    (jtab, jok), (ttab, tok) = _tables(jax_fns, b)
    jv = bool(np.asarray(jax_fns[2](jtab, jok, *b.jax_args(), jz)))
    tv = bool(trlc.verify_batch_rlc_gather(ttab, tok, *b.torch_args(),
                                           torch.from_numpy(tz)))
    assert jv == tv == expect, name
    if case == 0:
        pubs = torch.from_numpy(np.stack([np.frombuffer(pk, np.uint8)
                                          for pk, _, _ in b.lanes]))
        uv = trlc.verify_batch_rlc(pubs, *b.torch_args()[1:],
                                   torch.from_numpy(tz))
        assert bool(uv)


def test_dense_route_localizes_an_rlc_reject():
    """At RLC_MIN_LANES lanes the dense entry takes the RLC verdict
    first; on a reject the per-lane kernel names the bad lane."""
    n = tbatch.RLC_MIN_LANES
    args, items = dense_signature_batch(n, msg_len=60, seed=47, n_keys=8)
    pubs = np.stack([np.frombuffer(pk, np.uint8) for pk, _, _ in items])
    sigs = np.stack([np.frombuffer(s, np.uint8) for _, _, s in items])
    msgs = np.stack([np.frombuffer(m, np.uint8) for _, m, _ in items])
    lens = np.full((n,), 60)
    ok, oks = tbatch.verify_dense(pubs, sigs, msgs, lens, device="cpu",
                                  rng_bytes=bytes(range(256)) * (n // 16))
    assert ok and oks.all()
    sigs[37, 50] ^= 2
    ok, oks = tbatch.verify_dense(pubs, sigs, msgs, lens, device="cpu")
    assert not ok and np.nonzero(~oks)[0].tolist() == [37]
