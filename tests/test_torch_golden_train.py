"""The trainers' golden fixture (vsrcic_tpu_torch/testdata/golden_train.npz,
replayed on the card by chip_smoke.py phase 9 and on the CPU by
tests/test_torch_train.py) is what the JAX package computes today."""
import numpy as np

import torch_parity as tp


def test_golden_train_fixture_is_current():
    """Regenerating the trainers' fixture from JAX gives the committed
    arrays (rewrite it with `python tests/torch_parity.py`): inputs,
    parameters and greedy words exactly; losses and gradients to 1e-6
    relative."""
    want = tp.train_golden_arrays()
    with np.load(tp.GOLDEN_TRAIN) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            if "grad/" in k or "loss" in k:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-9, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
