"""The port's bulk kernels (``l2_distance``, ``topk``, ``lid_estimate``) and
the scans they carry (``brute_force_topk``, ``knn_graph``,
``estimate_dataset_lid``) against the reference on the same numpy inputs.

* The plain versions (what a CPU tensor runs) against the reference's Pallas
  kernels in interpret mode and its jnp oracles: squared L2 within 1e-4 for
  float32 and 2e-2 for bfloat16 (the reference's own kernel tolerances), top-k
  values bitwise and ids exactly, LID within 1e-4 relative.
* The scans on integer-valued data, where every float32 sum is exact in any
  order: ids and distances bit-identical.  On float data: distances within
  1e-4, LID within 1e-4 relative (reductions in another order, and the LID
  kernel's clamp of 1e-24 on d2 against the reference module's 1e-12 on r).
* ``gpu``-marked sweeps hold each CUDA kernel to its plain version on the
  card; they skip without one.  The reference is imported inside a fixture,
  so the file also runs on a machine without JAX
  (``pytest -m gpu --noconftest``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distance as tdist  # noqa: E402
from repro_torch.core import lid as tlid  # noqa: E402
from repro_torch.kernels import l2_distance as l2_kernel  # noqa: E402
from repro_torch.kernels import lid_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import topk as topk_kernel  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
L2_SHAPES = [(8, 64, 32), (130, 300, 96), (1, 129, 8)]
TOPK_N = [1500, 5000, 1025]
TOPK_K = [1, 10, 17, 32]
LID_SHAPES = [(100, 8), (700, 16), (512, 32)]


@pytest.fixture(scope="module")
def jx():
    """The reference's kernels and modules (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import distance, lid
    from repro.kernels import ref as jref
    from repro.kernels.l2_distance import l2_distance
    from repro.kernels.lid_kernel import lid_estimate
    from repro.kernels.topk import topk
    return dict(jnp=jnp, distance=distance, lid=lid, ref=jref,
                l2_distance=l2_distance, topk=topk, lid_estimate=lid_estimate)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _tied_rows(rng, n, k):
    """Rows built to stress the tie rule: few distinct values (many exact
    ties at the k-th value), and a row with fewer than k finite entries."""
    d = rng.integers(0, 6, (3, n)).astype(np.float32)
    d[1, :] = 2.0                              # every entry tied
    d[2, :] = np.inf
    d[2, rng.choice(n, max(1, k // 2), replace=False)] = 1.0
    return d


# ------------------------------------------------------ plain vs reference


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_n,x_n,d", L2_SHAPES)
def test_l2_plain_matches_reference_kernel(jx, q_n, x_n, d, dtype):
    jnp = jx["jnp"]
    rng = np.random.default_rng(q_n + x_n + d)
    q = rng.standard_normal((q_n, d), np.float32)
    x = rng.standard_normal((x_n, d), np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jx["l2_distance"](jnp.asarray(q, jdt),
                                        jnp.asarray(x, jdt), interpret=True))
    got = ops.bulk_l2(T(q).to(tdt), T(x).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (q_n, x_n)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jx["ref"].l2_distance_ref(
            jnp.asarray(q, jdt), jnp.asarray(x, jdt))), rtol=tol,
        atol=tol * 10)


@pytest.mark.parametrize("k", TOPK_K)
@pytest.mark.parametrize("n", TOPK_N)
def test_topk_plain_matches_reference_kernel(jx, n, k):
    jnp = jx["jnp"]
    d = np.random.default_rng(n + k).random((3, n), np.float32)
    got_v, got_i = ops.topk(T(d), k)
    assert got_i.dtype == torch.int32 and got_v.shape == (3, k)
    for want_v, want_i in (jx["topk"](jnp.asarray(d), k, interpret=True),
                           jx["ref"].topk_ref(jnp.asarray(d), k)):
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("k", TOPK_K)
def test_topk_plain_planted_ties(jx, k):
    """Ties go to the lower index and ids stay distinct where a row has
    fewer than k finite entries, as ``lax.top_k`` orders them.  (The
    reference's tile kernel can repeat an id in such a row; the port is held
    to the oracle.)"""
    jnp = jx["jnp"]
    d = _tied_rows(np.random.default_rng(k), 1025, k)
    got_v, got_i = ops.topk(T(d), k)
    want_v, want_i = jx["ref"].topk_ref(jnp.asarray(d), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert all(len(set(r)) == k for r in got_i.numpy().tolist())
    np.testing.assert_array_equal(got_i.numpy()[1], np.arange(k))
    # The tile kernel agrees on the rows whose top k are finite.
    kv, ki = jx["topk"](jnp.asarray(d[:2]), k, interpret=True)
    np.testing.assert_array_equal(got_i.numpy()[:2], np.asarray(ki))


@pytest.mark.parametrize("b,k", LID_SHAPES)
def test_lid_plain_matches_reference_kernel(jx, b, k):
    jnp = jx["jnp"]
    rng = np.random.default_rng(b)
    d2 = np.sort(rng.random((b, k), np.float32) + 0.01, axis=1)
    d2[0, :3] = 0.0                      # duplicated points: the clamp bites
    d2[1, :] = 0.5                       # equal distances: the -1/4096 cap
    got = ops.lid_estimate(T(d2))
    for want in (jx["lid_estimate"](jnp.asarray(d2), interpret=True),
                 jx["ref"].lid_ref(jnp.asarray(d2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert float(got[1]) == 4096.0


def test_topk_bounds_on_every_device():
    """Any 1 <= k <= N, as the reference's ``topk`` takes (k = 65 and
    k = N equal the plain version); k = 0 and k > N raise."""
    d = torch.rand(2, 100)
    d[0, :40] = 0.5                      # ties across the k-th value
    for k in (65, 100):
        got_v, got_i = ops.topk(d, k)
        want_v, want_i = ref.topk_ref(d, k)
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert torch.equal(ops.topk(d, 100)[1][1].sort().values,
                       torch.arange(100, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.topk(d, 101)                 # k > N
    with pytest.raises(ValueError):
        ops.topk(d[:, :5], 6)
    with pytest.raises(ValueError):
        ops.topk(d, 0)


@pytest.mark.parametrize("k", [65, 100, 256, 300])
def test_topk_plain_large_k_matches_reference(jx, k):
    """k past the warp-select's lists (64, 256) against the reference's
    oracle, and its Pallas kernel at k = 100 in interpret mode: values
    bitwise, ids exactly, planted ties included."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(k)
    d = np.concatenate([rng.random((2, 700), np.float32),
                        _tied_rows(rng, 700, k)])
    got_v, got_i = ops.topk(T(d), k)
    wants = [jx["ref"].topk_ref(jnp.asarray(d), k)]
    if k == 100:
        wants.append(jx["topk"](jnp.asarray(d[:2]), k, interpret=True))
    for want_v, want_i in wants:
        rows = np.asarray(want_v).shape[0]
        np.testing.assert_array_equal(got_v.numpy()[:rows], np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy()[:rows], np.asarray(want_i))
    assert all(len(set(r)) == k for r in got_i.numpy().tolist())


# --------------------------------------------------- scans vs reference


@pytest.mark.parametrize("chunk", [64, 300, 65536])
def test_brute_force_topk_integer_bit_identical(jx, chunk):
    jnp = jx["jnp"]
    rng = np.random.default_rng(21)
    x, q = _ints(rng, (700, 6)), _ints(rng, (11, 6))
    jd, ji = jx["distance"].brute_force_topk(jnp.asarray(q), jnp.asarray(x),
                                             k=17)
    td, ti = tdist.brute_force_topk(T(q), T(x), 17, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("integer", [True, False])
def test_brute_force_topk_k100_matches_reference(jx, integer):
    """Recall@100's ground truth: k = 100 against the reference's
    ``brute_force_topk``.  Integer data: ids and distances bit-identical.
    Float data: distances within 1e-4; ids equal in every row without a
    near-tie (a gap within 1e-4 relative) among its 101 nearest."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(26)
    if integer:
        x, q = _ints(rng, (900, 6)), _ints(rng, (13, 6))
    else:
        x = rng.standard_normal((900, 12), np.float32)
        q = rng.standard_normal((13, 12), np.float32)
    jd, ji = jx["distance"].brute_force_topk(jnp.asarray(q), jnp.asarray(x),
                                             k=100)
    td, ti = tdist.brute_force_topk(T(q), T(x), 100, chunk=256)
    assert td.shape == ti.shape == (13, 100)
    if integer:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        return
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    full = np.sort(((q[:, None, :] - x[None]) ** 2).sum(-1), 1)[:, :101]
    tie = (np.diff(full, axis=1) <= 1e-4 * full[:, 1:]).any(1)
    same = (ti.numpy() == np.asarray(ji)).all(1)
    assert (same | tie).all() and same.sum() >= 10


def test_knn_graph_k100_matches_reference(jx):
    """k = 100 (101 asked for, self dropped) on integer data with
    duplicates: ids and distances bit-identical to the reference's."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(27)
    x = _ints(rng, (500, 4), -3, 4)
    jd, ji = jx["distance"].knn_graph(jnp.asarray(x), k=100, chunk_q=128)
    td, ti = tdist.knn_graph(T(x), 100, chunk_q=96, chunk=160)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert not (ti.numpy() == np.arange(500)[:, None]).any()


def test_knn_graph_integer_with_duplicates(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(22)
    x = _ints(rng, (400, 4), -2, 3)      # 625 cells for 400 points: dups
    jd, ji = jx["distance"].knn_graph(jnp.asarray(x), k=16, chunk_q=128)
    td, ti = tdist.knn_graph(T(x), 16, chunk_q=96, chunk=160)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (td.numpy()[:, 0] == 0).any()


def test_scans_float(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(23)
    x = rng.standard_normal((600, 24), np.float32)
    q = rng.standard_normal((9, 24), np.float32)
    jd, ji = jx["distance"].brute_force_topk(jnp.asarray(q), jnp.asarray(x),
                                             k=10)
    td, ti = tdist.brute_force_topk(T(q), T(x), 10, chunk=256)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    assert np.mean([np.isin(a, b).mean() for a, b in
                    zip(ti.numpy(), np.asarray(ji))]) >= 0.99
    kd, _ = jx["distance"].knn_graph(jnp.asarray(x), k=12, chunk_q=256)
    td, _ = tdist.knn_graph(T(x), 12, chunk_q=200, chunk=256)
    np.testing.assert_allclose(td.numpy(), np.asarray(kd), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("integer", [True, False])
def test_estimate_dataset_lid_with_duplicates(jx, integer):
    """The LID kernel's clamp (1e-24 on d2) against the reference module's
    (1e-12 on r), on data where duplicated points put zeros in the k-NN
    distances: rtol 1e-4, as the reference holds its own pair."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(24)
    if integer:
        x = _ints(rng, (500, 5), -3, 4)
    else:
        x = rng.standard_normal((500, 8), np.float32)
    x[250:300] = x[:50]                            # exact duplicates
    t = tlid.estimate_dataset_lid(T(x), k=16, chunk_q=128, chunk=200)
    j = jx["lid"].estimate_dataset_lid(jnp.asarray(x), k=16, chunk_q=128)
    np.testing.assert_allclose(t.lid.numpy(), np.asarray(j.lid), rtol=1e-4)
    np.testing.assert_allclose(float(t.mu), float(j.mu), rtol=1e-4)
    np.testing.assert_allclose(float(t.sigma), float(j.sigma), rtol=1e-4)


# ----------------------------------------------------------- dispatch


def test_cpu_tensors_run_plain_versions_and_count_nothing():
    before = ops.launch_counts()
    assert set(before) == {"beam_step.exact", "beam_step.pq",
                           "beam_step.pq_rows", "l2_distance",
                           "topk", "lid_estimate", "pq_scan",
                           "decode_attention"}
    q, x = torch.rand(5, 8), torch.rand(40, 8)
    assert torch.equal(ops.bulk_l2(q, x), ref.l2_distance_ref(q, x))
    d = torch.rand(5, 40)
    for a, b in zip(ops.topk(d, 7), ref.topk_ref(d, 7)):
        assert torch.equal(a, b)
    d2 = torch.sort(torch.rand(5, 16), 1).values
    assert torch.equal(ops.lid_estimate(d2), ref.lid_ref(d2))
    tdist.brute_force_topk(q, x, 4)
    assert ops.launch_counts() == before


def test_kernels_raise_for_other_devices():
    m = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        ops.bulk_l2(m, m)
    with pytest.raises(ValueError):
        ops.topk(m, 2)
    with pytest.raises(ValueError):
        ops.lid_estimate(m)
    # Asking a CUDA wrapper for CPU tensors raises; it never hands back the
    # plain version.
    c = torch.rand(4, 8)
    with pytest.raises(ValueError):
        l2_kernel.l2_distance_cuda(c, c)
    with pytest.raises(ValueError):
        topk_kernel.topk_cuda(c, 2)
    with pytest.raises(ValueError):
        lid_kernel.lid_estimate_cuda(c)


def test_topk_segments_cover_the_row():
    # slots: resident warps of the select, e.g. 132 SMs x 4 blocks x 8 warps.
    for slots in (4224, 1, 100_000):
        for q, n in [(1, 1_000_000), (4096, 65536), (3, 1025),
                     (10000, 65536), (64, 5000), (256, 1_000_000)]:
            seg = topk_kernel.segment_length(q, n, slots)
            segs = -(-n // seg)
            assert 1 <= seg <= n and (segs - 1) * seg < n <= segs * seg
            # Segments never outnumber the slots the rows leave free.
            assert segs == 1 or q * segs <= slots
    # The k-NN's rows fill the card alone; [adc]'s 256 rows take 16
    # segments each, one wave of 4096 warps.
    assert topk_kernel.segment_length(4096, 65536, 4224) == 65536
    assert topk_kernel.segment_length(256, 1_000_000, 4224) == 62500


# ------------------------------------------------------------ on the card


def _count(name):
    return ops.launch_counts()[name]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_n,x_n,d", L2_SHAPES + [(257, 1031, 960),
                                                   (4096, 2048, 128)])
def test_l2_kernel_matches_plain_on_card(card, q_n, x_n, d, dtype):
    g = torch.Generator(device=card).manual_seed(q_n + x_n)
    tdt = getattr(torch, dtype)
    q = torch.randn((q_n, d), generator=g, device=card).to(tdt)
    x = torch.randn((x_n, d), generator=g, device=card).to(tdt)
    before = _count("l2_distance")
    got = ops.bulk_l2(q, x)
    want = ref.l2_distance_ref(q, x)
    torch.cuda.synchronize()
    assert _count("l2_distance") == before + 1
    rtol, atol = (1e-4, 1e-3) if dtype == "float32" else (2e-2, 2e-1)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("k", TOPK_K + [64])
@pytest.mark.parametrize("q,n", [(3, 1025), (2, 200_000), (300, 65536),
                                 (64, 5000)])
def test_topk_kernel_matches_plain_on_card(card, q, n, k):
    g = torch.Generator(device=card).manual_seed(q * n + k)
    d = torch.rand((q, n), generator=g, device=card)
    d[0] = torch.randint(0, 5, (n,), generator=g, device=card).float()
    d[-1] = torch.inf
    d[-1, torch.randperm(n, generator=g, device=card)[:max(1, k // 2)]] = 1.0
    before = _count("topk")
    got_v, got_i = ops.topk(d, k)
    want_v, want_i = ref.topk_ref(d, k)
    torch.cuda.synchronize()
    assert _count("topk") == before + 1
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_i, want_i)


@pytest.mark.gpu
@pytest.mark.parametrize("b,k", LID_SHAPES + [(100_000, 16), (37, 1)])
def test_lid_kernel_matches_plain_on_card(card, b, k):
    g = torch.Generator(device=card).manual_seed(b)
    d2 = torch.sort(torch.rand((b, k), generator=g, device=card) + 0.01,
                    dim=1).values
    d2[0, :max(1, k // 2)] = 0.0
    before = _count("lid_estimate")
    got = ops.lid_estimate(d2)
    want = ref.lid_ref(d2)
    torch.cuda.synchronize()
    assert _count("lid_estimate") == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.gpu
def test_scans_on_card_match_cpu(card):
    """The scans through the kernels on the card equal the plain path on the
    CPU on integer data (every sum exact)."""
    rng = np.random.default_rng(25)
    x = _ints(rng, (3000, 16))
    q = _ints(rng, (70, 16))
    td, ti = tdist.brute_force_topk(T(q).to(card), T(x).to(card), 17,
                                    chunk=1000)
    cd, ci = tdist.brute_force_topk(T(q), T(x), 17, chunk=1000)
    assert torch.equal(ti.cpu(), ci) and torch.equal(td.cpu(), cd)
    kd, ki = tdist.knn_graph(T(x).to(card), 16, chunk_q=512, chunk=1000)
    pd, pi = tdist.knn_graph(T(x), 16, chunk_q=512, chunk=1000)
    assert torch.equal(ki.cpu(), pi) and torch.equal(kd.cpu(), pd)


@pytest.mark.gpu
def test_l2_kernel_integer_bit_identical_on_card(card):
    """SIFT's integer range (0-255) at the k-NN width: TF32's big part is
    exact and its small part 0, every sum is below 2^24, so the tensor
    cores' result equals the plain version's bit for bit."""
    g = torch.Generator(device=card).manual_seed(31)
    q = torch.randint(0, 256, (4096, 128), generator=g, device=card).float()
    x = torch.randint(0, 256, (8192, 128), generator=g, device=card).float()
    x[:64] = q[:64]                                   # d2 = 0 pairs
    got = ops.bulk_l2(q, x)
    want = ref.l2_distance_ref(q, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[torch.arange(64), torch.arange(64)] == 0).all())


@pytest.mark.gpu
def test_l2_kernel_sift_near_duplicates_on_card(card):
    """SIFT-scale coordinates (0-255) with a near duplicate of every query
    (d2 about 2% of |q|^2): within rtol 1e-4 / atol 1e-3 of a float64
    distance, and no more than 4x the plain float32 version's error."""
    g = torch.Generator(device=card).manual_seed(32)
    q = torch.rand((512, 128), generator=g, device=card) * 255
    near = (q + (torch.rand(q.shape, generator=g, device=card) - 0.5) * 80)
    far = torch.rand((1536, 128), generator=g, device=card) * 255
    x = torch.cat([near.clamp(0, 255), far])
    q64, x64 = q.double(), x.double()
    truth = ((q64 * q64).sum(1, keepdim=True) - 2 * q64 @ x64.T
             + (x64 * x64).sum(1)).clamp_min(0)
    got = ops.bulk_l2(q, x)
    plain = ref.l2_distance_ref(q, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), truth, rtol=1e-4, atol=1e-3)
    err = float((got.double() - truth).abs().max())
    assert err <= 4 * float((plain.double() - truth).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 20, 21, 96, 960])
def test_l2_kernel_widths_on_card(card, d, dtype):
    """Depths that are not a multiple of the 32-element stage, rows that
    are not 16-byte aligned (D = 21; bf16 D = 20), and N % 4 != 0."""
    g = torch.Generator(device=card).manual_seed(d)
    tdt = getattr(torch, dtype)
    q = torch.randn((131, d), generator=g, device=card).to(tdt)
    x = torch.randn((1027, d), generator=g, device=card).to(tdt)
    got = ops.bulk_l2(q, x)
    want = ref.l2_distance_ref(q, x)
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 1e-3) if dtype == "float32" else (2e-2, 2e-1)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _hard_rows(g, card, q, n, k):
    """Rows that stress the select: planted ties, an all-+inf row, a row
    with NaN (at least k entries stay numbers), a descending row (every
    element passes the bar), and random rows."""
    d = torch.rand((q, n), generator=g, device=card)
    d[0] = torch.randint(0, 5, (n,), generator=g, device=card).float()
    d[1] = torch.inf
    nan = torch.rand((n,), generator=g, device=card) < 0.3
    nan[:k] = False
    d[2, nan] = torch.nan
    d[3] = torch.arange(n, 0, -1, device=card).float()
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 17, 64])
@pytest.mark.parametrize("n", [1025, 5000, 65537])
def test_topk_kernel_unaligned_rows_on_card(card, n, k):
    g = torch.Generator(device=card).manual_seed(n + k)
    for q in (6, 4):            # 4 rows: segments where n allows them
        d = _hard_rows(g, card, q, n, k)
        got_v, got_i = ops.topk(d, k)
        want_v, want_i = ref.topk_ref(d, k)
        torch.cuda.synchronize()
        assert torch.equal(got_v, want_v)
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_i[1], torch.arange(k, device=card,
                                                  dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,k", [(256, 1_000_000, 10), (70_000, 64, 10)])
def test_topk_kernel_path_shapes_on_card(card, q, n, k):
    """[adc]'s chunk (256 x 1M, cut into segments) and more rows than a
    grid's y dimension takes (65,535)."""
    g = torch.Generator(device=card).manual_seed(q)
    d = _hard_rows(g, card, q, n, k)
    before = _count("topk")
    got_v, got_i = ops.topk(d, k)
    want_v, want_i = ref.topk_ref(d, k)
    torch.cuda.synchronize()
    assert _count("topk") == before + 1
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_i, want_i)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [65, 100, 101, 256, 257, 2048])
@pytest.mark.parametrize("q,n", [(6, 5000), (4, 65537), (300, 4099)])
def test_topk_kernel_large_k_on_card(card, q, n, k):
    """The 128- and 256-key warp-selects (k = 65-256; 4 rows of 65537 are
    cut into segments) and the radix select past 256, on planted ties, an
    all-+inf row, NaN and a descending row: values bitwise, ids equal, one
    launch counted a call."""
    g = torch.Generator(device=card).manual_seed(n + k)
    d = _hard_rows(g, card, q, n, k)
    before = _count("topk")
    got_v, got_i = ops.topk(d, k)
    want_v, want_i = ref.topk_ref(d, k)
    torch.cuda.synchronize()
    assert _count("topk") == before + 1
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_i[1], torch.arange(k, device=card,
                                              dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 64, 100, 256, 257, 1000, 5001])
def test_topk_kernel_k_equals_n_on_card(card, n):
    """k = N on short rows: every entry, in (value, id) order."""
    g = torch.Generator(device=card).manual_seed(n)
    d = _hard_rows(g, card, 5, n, n)
    got_v, got_i = ops.topk(d, n)
    want_v, want_i = ref.topk_ref(d, n)
    torch.cuda.synchronize()
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_i, want_i)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16, 20, 33, 100])
def test_lid_kernel_k_sweep_on_card(card, k):
    """k = 1 (the -1/4096 cap), 16 (a row in one 16-element pass), 20 and
    100 (16-byte loads, chunks of 32) and 33 (scalar loads), with zero
    distances and an all-zero row; rows that start off a 16-byte boundary
    too: within rtol 1e-4."""
    g = torch.Generator(device=card).manual_seed(k)
    d2 = torch.sort(torch.rand((70_001, k), generator=g, device=card) + 0.01,
                    dim=1).values
    d2[:100, :max(1, k // 4)] = 0.0
    d2[100] = 0.0
    for rows in (d2, d2[1:]):
        got = ops.lid_estimate(rows)
        want = ref.lid_ref(rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    assert float(ops.lid_estimate(d2)[100]) == 4096.0
