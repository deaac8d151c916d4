"""The port's PQ tier against the reference.

Tolerances: LUTs and ADC sums within 1e-5 (the reference kernel's PQ
tolerance); codes identical given the reference's codebook on integer data,
and on float data different only where two centroids tie within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ivf as jivf  # noqa: E402
from repro.pq import adc as jadc  # noqa: E402
from repro.pq import codebook as jcb  # noqa: E402
from repro.pq import encode as jenc  # noqa: E402
from repro_torch.core import ivf as tivf  # noqa: E402
from repro_torch.pq import adc as tadc  # noqa: E402
from repro_torch.pq import codebook as tcb  # noqa: E402
from repro_torch.pq import encode as tenc  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy


def _book(seed, m=4, k=16, dsub=3, integer=False):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((m, k, dsub)).astype(np.float32) * 3
    return np.round(c) if integer else c


def test_build_lut_and_adc():
    rng = np.random.default_rng(0)
    cent = _book(0)
    q = rng.standard_normal((5, 12)).astype(np.float32)
    codes = rng.integers(0, 16, (70, 4)).astype(np.uint8)
    tl = tadc.build_lut(T(q), T(cent))
    jl = jadc.build_lut(jnp.asarray(q), jnp.asarray(cent))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tadc.adc_distances(tl, T(codes), chunk=32).numpy(),
        np.asarray(jadc.adc_distances(jl, jnp.asarray(codes))),
        rtol=1e-5, atol=1e-5)


def test_pq_encode_identical_given_reference_codebook():
    rng = np.random.default_rng(1)
    cent = _book(1, integer=True)
    x = rng.integers(-4, 5, (300, 12)).astype(np.float32)
    want = jenc.pq_encode(jnp.asarray(x), jcb.PqCodebook(jnp.asarray(cent)))
    got = tenc.pq_encode(T(x), tcb.PqCodebook(T(cent)), chunk=64)
    # Integer data ties exactly between centroids: argmin takes the first,
    # so even the ties agree.
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pq_encode_float_differs_only_at_near_ties():
    rng = np.random.default_rng(2)
    cent = _book(2)
    x = rng.standard_normal((500, 12)).astype(np.float32) * 2
    want = np.asarray(jenc.pq_encode(jnp.asarray(x),
                                     jcb.PqCodebook(jnp.asarray(cent))))
    got = tenc.pq_encode(T(x), tcb.PqCodebook(T(cent))).numpy()
    subs = x.reshape(500, 4, 3)
    for i, j in zip(*np.nonzero(got != want)):
        d = ((subs[i, j] - cent[j]) ** 2).sum(-1)
        assert abs(d[got[i, j]] - d[want[i, j]]) <= 1e-5 * d.max()
    assert (got == want).mean() > 0.99


def test_kmeans_from_the_reference_seeds():
    """Given the reference's initial rows, Lloyd's iterations land on the
    same centroids (well-separated clusters: no assignment near a tie)."""
    rng = np.random.default_rng(3)
    centers = rng.integers(-50, 51, (6, 4)).astype(np.float32)
    x = (centers[rng.integers(0, 6, 600)]
         + rng.integers(-2, 3, (600, 4))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    init = np.array(jax.random.choice(key, 600, shape=(6,), replace=False))
    want = jivf.kmeans(jnp.asarray(x), 6, iters=6, key=key)
    got = tivf.kmeans(T(x), 6, iters=6, init=T(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_train_pq_distortion_matches_reference():
    """The port draws its own sample and seeds: held by quantisation
    distortion, within 10% of the reference's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2000, 16)).astype(np.float32)

    def distortion(codes, cent):
        dec = cent[np.arange(cent.shape[0]), codes.astype(int)].reshape(
            codes.shape[0], -1)
        return float(((dec - x) ** 2).sum(1).mean())

    jb = jcb.train_pq(jnp.asarray(x), m=4, k=32, iters=6, sample=1000)
    tb = tcb.train_pq(T(x), m=4, k=32, iters=6, sample=1000)
    assert tuple(tb.centroids.shape) == (4, 32, 4)
    jd = distortion(np.asarray(jenc.pq_encode(jnp.asarray(x), jb)),
                    np.asarray(jb.centroids))
    td = distortion(tenc.pq_encode(T(x), tb).numpy(), tb.centroids.numpy())
    assert td <= 1.1 * jd
