"""Why ``csrc/l2_distance.cu`` takes its float32 cross term as three TF32
products (3xTF32), checked on the CPU by emulating the tensor cores' TF32
rounding (``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to
10 mantissa bits) with integer bit operations on float32 arrays.

The emulation follows the kernel's arithmetic: each operand v is split into
big = rna(v) and small = rna(v - big); the cross term is accumulated in
float32 over k-steps of 8 as small.big + big.small + big.big (the products
of one step summed by a float32 matmul, as the tensor core sums them); the
distance is the reference's max((|q|^2 - 2 q.x) + |x|^2, 0) with float32
norms.

The data are SIFT-scale: coordinates in [0, 255], |q|^2 near 2.8e6 at
D = 128, and near-duplicate pairs (every coordinate moved by at most 40),
whose d2 is about 2% of |q|^2.  The reference's float32 formula itself loses
a few units of d2 to the cancellation of |q|^2 - 2 q.x (an ulp of |q|^2 is
0.25), so it holds rtol 1e-4 only where d2 is at least a few times 1e4;
closer pairs are out of reach of any float32 kernel of this formula.

* (a) 3xTF32 holds rtol 1e-4 / atol 1e-3 of the float64 truth on such
  data, with an error no more than 4x the plain float32 version's;
* (b) one TF32 pass misses it by two orders of magnitude;
* (c) on integer data with |v| <= 2048 small is 0, and at SIFT's integer
  range (0-255, every sum below 2^24) the emulated distance equals the
  exact one and the port's plain version bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

RTOL, ATOL = 1e-4, 1e-3


def rna_tf32(a: np.ndarray) -> np.ndarray:
    """Round float32 values to TF32 (10 mantissa bits) to nearest, ties away
    from zero: add half of the 13 dropped bits to the magnitude, then drop
    them (a carry into the exponent is the round-up it should be)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    big = rna_tf32(a)
    return big, rna_tf32(a - big)


def emulated_l2(q: np.ndarray, x: np.ndarray, passes: int) -> np.ndarray:
    """Squared L2 with the cross term as the kernel takes it: ``passes`` = 3
    for 3xTF32, 1 for one TF32 pass (big.big only)."""
    qb, qs = split(q)
    xb, xs = split(x)
    dot = np.zeros((q.shape[0], x.shape[0]), np.float32)
    for k0 in range(0, q.shape[1], 8):
        s = slice(k0, k0 + 8)
        if passes == 3:
            dot += qs[:, s] @ xb[:, s].T
            dot += qb[:, s] @ xs[:, s].T
        dot += qb[:, s] @ xb[:, s].T
    qn = np.einsum("ij,ij->i", q, q, dtype=np.float32)
    xn = np.einsum("ij,ij->i", x, x, dtype=np.float32)
    return np.maximum((qn[:, None] - np.float32(2) * dot) + xn[None, :],
                      np.float32(0))


def plain_l2(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy
    return ref.l2_distance_ref(t(q), t(x)).numpy()


def truth_l2(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    diff = (q[:, None, :].astype(np.float64)
            - x[None, :, :].astype(np.float64))
    return (diff * diff).sum(-1)


def sift_near_duplicates(seed: int, d: int, nq: int = 48, nfar: int = 80):
    """Queries uniform in [0, 255]; base = one near duplicate of each query
    (coordinates moved by up to 40, clipped to [0, 255]) plus far points."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 255, (nq, d)).astype(np.float32)
    near = np.clip(q + rng.uniform(-40, 40, q.shape), 0, 255)
    far = rng.uniform(0, 255, (nfar, d))
    return q, np.concatenate([near, far]).astype(np.float32)


@pytest.mark.parametrize("seed,d", [(0, 96), (1, 128), (2, 128)])
def test_3xtf32_holds_tolerance_at_sift_scale(seed, d):
    q, x = sift_near_duplicates(seed, d)
    want = truth_l2(q, x)
    near = want[np.arange(len(q)), np.arange(len(q))]
    qn = (q.astype(np.float64) ** 2).sum(1)
    assert (near < 0.05 * qn).all()                 # d2 << |q|^2
    got = emulated_l2(q, x, passes=3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    err = np.abs(got - want).max()
    assert err <= 4 * np.abs(plain_l2(q, x) - want).max()


@pytest.mark.parametrize("seed,d", [(0, 96), (1, 128), (2, 128)])
def test_one_tf32_pass_misses_tolerance(seed, d):
    q, x = sift_near_duplicates(seed, d)
    want = truth_l2(q, x)
    one = emulated_l2(q, x, passes=1)
    excess = np.abs(one - want) / (ATOL + RTOL * np.abs(want))
    assert excess.max() > 10.0
    # ... while the plain float32 version holds it on the same data.
    np.testing.assert_allclose(plain_l2(q, x), want, rtol=RTOL, atol=ATOL)


def test_integers_up_to_2048_have_no_small_part():
    v = np.arange(-2048, 2049, dtype=np.float32)
    big, small = split(v)
    np.testing.assert_array_equal(big, v)
    assert not small.any()


@pytest.mark.parametrize("d", [8, 128])
def test_integer_sift_range_is_exact(d):
    rng = np.random.default_rng(d)
    q = rng.integers(0, 256, (40, d)).astype(np.float32)
    x = rng.integers(0, 256, (300, d)).astype(np.float32)
    x[:10] = q[:10]                                 # d2 = 0 pairs
    got = emulated_l2(q, x, passes=3)
    np.testing.assert_array_equal(got, truth_l2(q, x).astype(np.float32))
    np.testing.assert_array_equal(got, plain_l2(q, x))
