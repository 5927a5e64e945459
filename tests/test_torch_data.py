"""Data parity: periodicity_tpu_torch.data vs the JAX package's data.

Loaders read the same ``.npy`` files; generators draw the same numpy
streams from the same seeds. Every value is equal, and the port's
doctests run.
"""

import doctest

import numpy as np
import pytest

import periodicity_tpu.data as J
import periodicity_tpu_torch.data as P


@pytest.mark.parametrize("name,args", [
    ("SpottedStar", {}),
    ("SunSpots", {}),
    ("TSI", {}),
    ("BPSK", {"t_bit": 10, "n_bits": 400, "f_c": 0.05, "n0_db": -3.0, "seed": 4}),
    ("SustainedPlusGappedPureTones", {}),
    ("GaussianAtomsPlusFMSinusoid", {}),
    ("DuffingWave", {}),
])
def test_data_equals_jax(name, args):
    got = getattr(P, name)(**args)
    want = getattr(J, name)(**args)
    assert type(got) is np.ndarray and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_data_module_doctests():
    assert sorted(P.__all__) == sorted(J.__all__)
    results = doctest.testmod(P, verbose=False)
    assert results.attempted >= 7 and results.failed == 0
