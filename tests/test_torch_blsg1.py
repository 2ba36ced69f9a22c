"""K9, the masked BLS12-381 G1 sum: the port's packers and plain version
against the JAX package.

The JAX function runs eagerly (``cometbft_tpu.ops.blsg1.
aggregate_g1_masked`` without ``jax.jit``: the XLA compile of the
unrolled field arithmetic takes minutes on a CPU, the eager calls of this
file about 20 s, made once in a module-scoped fixture).  Projective
limbs must be equal exactly: both packages add in the same tree order
with fully reduced field values, so not even the projective scale
differs.  Larger sums (64 and 300 rows) are held, as affine bytes,
against the JAX package's host ``bls12381.aggregate_affine`` over the
selected points; its ``ValueError`` for an infinity sum must be ``None``
here.  Points come from secrets drawn with numpy from a fixed seed."""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import bls12381 as JB
from cometbft_tpu.ops import blsg1 as JG
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import blsg1 as TG

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(900)


@pytest.fixture(scope="module")
def points():
    """300 affine public keys (96 bytes x||y) from seeded secrets."""
    rng = np.random.default_rng(91)
    secrets = [int(s) for s in rng.integers(1, 1 << 62, size=300)]
    return [JB.pk_to_affine(JB._BACKEND.sk_to_pk(s)) for s in secrets]


def limbs(pts):
    return np.stack([JG.limbs_from_xy(p) for p in pts]).astype(np.int32)


EAGER_CASES = {1: [1], 3: [1, 0, 1], 8: [1, 1, 0, 1, 0, 0, 1, 1]}


@pytest.fixture(scope="module")
def eager(points):
    """The JAX package's eager projective sums at R = 1, 3 (padded to 4)
    and 8."""
    import jax.numpy as jnp

    out = {}
    for r, mask in EAGER_CASES.items():
        m = np.array(mask, np.int32)
        out[r] = np.asarray(JG.aggregate_g1_masked(
            jnp.asarray(limbs(points[:r])), jnp.asarray(m)))
    return out


def test_packers_match_jax(points):
    rng = np.random.default_rng(7)
    for v in [0, 1, TG.P_INT - 1, (1 << 381) - 1] + [
            int.from_bytes(rng.bytes(48), "big") % TG.P_INT
            for _ in range(20)]:
        assert np.array_equal(TG.limbs_from_int(v), JG.limbs_from_int(v))
        assert TG.int_from_limbs(TG.limbs_from_int(v)) == \
            JG.int_from_limbs(JG.limbs_from_int(v)) == v
    for p in points[:10]:
        assert np.array_equal(TG.limbs_from_xy(p), JG.limbs_from_xy(p))
    with pytest.raises(ValueError):
        TG.limbs_from_xy(points[0][:95])
    assert TG.P_INT == JG.P_INT and TG.NLIMB == JG.NLIMB and TG.LB == JG.LB
    for mine, theirs in ((TG.R2_INT, JG._R2), (TG.ONE_M_INT, JG._ONE_M),
                         (TG.B3_M_INT, JG._B3_M)):
        assert np.array_equal(TG.limbs_from_int(mine), theirs)
    for _ in range(5):
        proj = np.stack([JG.limbs_from_int(
            int.from_bytes(rng.bytes(48), "big") % TG.P_INT)
            for _ in range(3)])
        assert TG.xy_from_projective(proj) == JG.xy_from_projective(proj)
    proj[2] = 0
    assert TG.xy_from_projective(proj) is JG.xy_from_projective(proj) is None


@pytest.mark.parametrize("r", sorted(EAGER_CASES))
def test_plain_sum_equals_eager_jax_limbs(points, eager, r):
    m = torch.tensor(EAGER_CASES[r], dtype=torch.int32)
    got = TG.aggregate_g1_masked(torch.from_numpy(limbs(points[:r])), m)
    assert got.dtype == torch.int32 and got.shape == (3, 32)
    assert np.array_equal(got.numpy(), eager[r])


def _masks(rng, r):
    """Random, empty, single, cancelling (a row and its negation) and
    doubled (one point in two rows) masks over a table whose last two
    rows are the negation of row 0 and a copy of row 1."""
    rand = (rng.random(r) < 0.5).astype(np.int32)
    rand[[0, r - 1]] = 0
    single = np.zeros(r, np.int32)
    single[r // 2] = 1
    cancel = np.zeros(r, np.int32)
    cancel[[0, r - 2]] = 1
    double = np.zeros(r, np.int32)
    double[[1, r - 1]] = 1
    double[5:9] = 1
    return {"random": rand, "empty": np.zeros(r, np.int32),
            "single": single, "cancelling": cancel, "doubled": double}


@pytest.mark.parametrize("r", [64, 300])
def test_plain_sum_against_host_aggregate_affine(points, r):
    rng = np.random.default_rng(r)
    table = list(points[:r - 2]) + [JB.negate_affine(points[0]), points[1]]
    lt = torch.from_numpy(limbs(table))
    for name, mask in _masks(rng, r).items():
        out = TG.aggregate_g1_masked(lt, torch.from_numpy(mask))
        got = TG.xy_from_projective(out.numpy())
        try:
            want = JB.aggregate_affine([table[i] for i in np.flatnonzero(
                mask)])
        except ValueError:
            want = None
        assert got == want, name
        if name in ("empty", "cancelling"):
            assert got is None


def test_word_table_route_and_argument_checks(points):
    """``g1_masked_sum`` over the kernel's word layout is the same sum;
    the wrappers refuse other dtypes, shapes and layouts."""
    lt = torch.from_numpy(limbs(points[:20]))
    words = TG.words_from_limbs(lt)
    assert words.shape == (20, 2, 12) and words.dtype == torch.int32
    w = words.numpy().view(np.uint32).astype(object)
    for i in range(20):
        x = sum(int(w[i, 0, k]) << (32 * k) for k in range(12))
        assert x.to_bytes(48, "big") == points[i][:48]
    mask = torch.from_numpy((np.arange(20) % 3 != 0).astype(np.int32))
    _build.PLAIN_CALLS.clear()
    assert torch.equal(TG.g1_masked_sum(words, mask),
                       TG.aggregate_g1_masked(lt, mask))
    assert _build.PLAIN_CALLS["aggregate_g1_masked"] == 2
    with pytest.raises(TypeError):
        TG.g1_masked_sum(words, mask.to(torch.int64))
    with pytest.raises(ValueError):
        TG.g1_masked_sum(words[:, :1].contiguous(), mask)
    with pytest.raises(ValueError):
        TG.aggregate_g1_masked(lt, mask[:19])
    with pytest.raises(ValueError):           # not contiguous
        TG.g1_masked_sum(words.transpose(0, 1).contiguous().transpose(0, 1),
                         mask)
