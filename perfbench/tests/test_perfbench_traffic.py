"""The traffic generators: deterministic in the seed, different across
seeds, of the configuration's shape, and importing nothing of the port."""
import numpy as np
import pytest

from perfbench.yardstick import spec


@pytest.mark.parametrize("name,m", [("make_classification", 20), ("make_higgs_like", 28)])
def test_generator_deterministic_in_seed(name, m):
    gen = spec.load_generator(name)
    a = gen.generate(3000, {"num_features": m}, 2**31 + 7, "cpu")
    b = gen.generate(3000, {"num_features": m}, 2**31 + 7, "cpu")
    c = gen.generate(3000, {"num_features": m}, 2**31 + 8, "cpu")
    assert a[0].shape == (3000, m) and a[1].shape == (3000,)
    assert np.array_equal(a[0].numpy(), b[0].numpy()) and np.array_equal(a[1].numpy(), b[1].numpy())
    assert not np.array_equal(a[0].numpy(), c[0].numpy())
    assert set(np.unique(a[1].numpy())) <= {0.0, 1.0}
    assert 0.3 < float(a[1].mean()) < 0.7


def test_classification_blocks():
    gen = spec.load_generator("make_classification")
    X, y = gen.generate(20000, {"num_features": 30}, 5, "cpu")
    X, y = X.numpy().astype(np.float64), y.numpy()
    ni = 3
    # informative features separate the classes, noise features do not
    gap = np.abs(X[y == 1].mean(0) - X[y == 0].mean(0))
    assert gap[:ni].max() > 0.3 and gap[2 * ni:].max() < 0.1
    # the redundant block is a linear map of the informative one
    coef, res, *_ = np.linalg.lstsq(X[:, :ni], X[:, ni:2 * ni], rcond=None)
    assert float(res.max()) < 1e-6 * len(X)
