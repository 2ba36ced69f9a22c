"""The host kernel harness (``tests/torch_kernels_host_fixtures.py``) on
the BLS12-381 G1 fold, against its plain PyTorch version, exactly."""

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.ops import blsg1

from torch_kernels_host_fixtures import harness, needs_gxx  # noqa: F401

# the plain versions run on tensors of a few lanes: one intra-op thread is
# as fast, and leaves the cores to the other test workers
torch.set_num_threads(1)

pytestmark = [pytest.mark.timeout(900), needs_gxx]


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
