"""The port's ``decode_attention`` and ``pq_scan`` kernels and the bulk ADC
retrieval they carry (``adc_topk``), against the reference on the same
numpy inputs.

* The plain versions (what a CPU tensor runs) against the reference's
  Pallas kernels in interpret mode and its jnp oracles: decode attention
  within 3e-4 and the ADC scan within 1e-5, the reference's own kernel
  tolerances (``tests/test_kernels.py``).  kv_len = 0 gives zeros on both
  sides (the TPU kernel's guard); kv_len > S counts as S, as in the
  reference's oracle.
* ``adc_topk`` against the reference's: on integer-valued LUTs every sum
  is exact in any order, so values and ids are identical; on float LUTs
  values agree within 1e-5 and ids agree except at near-ties.
* ``gpu``-marked sweeps hold each CUDA kernel to its plain version on the
  card; they skip without one.  The reference is imported inside a
  fixture, so the file also runs on a machine without JAX
  (``pytest -m gpu --noconftest``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mapping as tmapping  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.kernels import decode_attention as da_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import pq_scan as pq_kernel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.pq import adc as tadc  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
# (B, Hq, Hkv, S, d): the reference's sweep (test_kernels.py:63) plus a
# group of 2 and a group of 7 (qwen2-7b's) with S not a multiple of 512,
# and d = 8 (the reference's deepseek_coder_33b smoke config).
DA_SHAPES = [(2, 8, 2, 700, 64), (1, 4, 4, 512, 32), (3, 6, 1, 130, 16),
             (2, 4, 2, 300, 16), (2, 14, 2, 1000, 32), (2, 8, 2, 300, 8)]
# (N, M, K, Q): the reference's sweep (test_kernels.py:38) plus M not a
# multiple of 16 with K not a power of two.
PQ_SHAPES = [(200, 8, 16, 2), (513, 16, 256, 3), (64, 4, 64, 1),
             (300, 20, 100, 5)]


@pytest.fixture(scope="module")
def jx():
    """The reference's kernels and modules (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.pq_scan import pq_scan
    from repro.pq import adc as jadc
    return dict(jax=jax, jnp=jnp, ref=jref, decode_attention=decode_attention,
                pq_scan=pq_scan, adc=jadc)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _attn_inputs(rng, b, hq, hkv, s, d):
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    return q, k, v


# ------------------------------------------------------ plain vs reference


@pytest.mark.parametrize("b,hq,hkv,s,d", DA_SHAPES)
def test_decode_attention_plain_matches_reference_kernel(jx, b, hq, hkv, s,
                                                         d):
    jnp = jx["jnp"]
    rng = np.random.default_rng(s + hq)
    q, k, v = _attn_inputs(rng, b, hq, hkv, s, d)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    lens[0] = 1
    lens[-1] = s
    got = ops.decode_attention(T(q), T(k), T(v), T(lens)).numpy()
    kern = jx["decode_attention"](jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lens),
                                  interpret=True)
    g = hq // hkv
    oracle = jx["ref"].decode_attention_ref(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, axis=2),
        jnp.repeat(jnp.asarray(v), g, axis=2), jnp.asarray(lens))
    grouped = jx["ref"].decode_attention_gqa_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    for want in (kern, oracle, grouped):
        np.testing.assert_allclose(got, np.asarray(want), rtol=3e-4,
                                   atol=3e-4)
    # The port's own one-head-per-group oracle agrees as well.
    rep = ref.decode_attention_ref(T(q), T(np.repeat(k, g, 2)),
                                   T(np.repeat(v, g, 2)), T(lens))
    np.testing.assert_allclose(got, rep.numpy(), rtol=3e-4, atol=3e-4)


def test_decode_attention_empty_row_gives_zeros(jx):
    """kv_len = 0: zeros from the plain version, as from the TPU kernel's
    guard (the reference's oracle gives NaN there)."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(5)
    q, k, v = _attn_inputs(rng, 3, 8, 2, 600, 32)
    lens = np.array([0, 17, 600], np.int32)
    got = ops.decode_attention(T(q), T(k), T(v), T(lens)).numpy()
    kern = np.asarray(jx["decode_attention"](
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        interpret=True))
    assert np.all(got[0] == 0.0) and np.all(kern[0] == 0.0)
    np.testing.assert_allclose(got, kern, rtol=3e-4, atol=3e-4)
    assert np.isnan(np.asarray(jx["ref"].decode_attention_gqa_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lens)))[0]).all()


def test_decode_attention_length_past_cache_is_clamped(jx):
    """kv_len > S counts as S, as the reference's oracle masks arange(S)."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(6)
    s = 130
    q, k, v = _attn_inputs(rng, 2, 14, 2, s, 16)
    lens = np.array([s + 1, s + 700], np.int32)
    got = ops.decode_attention(T(q), T(k), T(v), T(lens)).numpy()
    full = ops.decode_attention(T(q), T(k), T(v),
                                T(np.full(2, s, np.int32))).numpy()
    assert np.array_equal(got, full)
    want = jx["ref"].decode_attention_gqa_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("n,m,k,q", PQ_SHAPES)
def test_pq_scan_plain_matches_reference_kernel(jx, n, m, k, q):
    jnp, jax = jx["jnp"], jx["jax"]
    rng = np.random.default_rng(n + m)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    luts = rng.random((q, m, k), dtype=np.float32)
    got = ops.pq_bulk_scan(T(luts), T(codes)).numpy()
    kern = jx["pq_scan"](jnp.asarray(luts), jnp.asarray(codes),
                         interpret=True)
    oracle = jax.vmap(lambda l: jx["ref"].pq_scan_ref(l, jnp.asarray(codes)))(
        jnp.asarray(luts))
    for want in (kern, oracle):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        got, tadc.adc_distances(T(luts), T(codes)).numpy(), rtol=1e-5,
        atol=1e-5)


def test_adc_query_chunk():
    assert tadc.query_chunk(1_000_000) == 256
    assert tadc.query_chunk(1 << 28) == 1
    for n in (1, 1000, 1_000_000, 3_000_000):
        qc = tadc.query_chunk(n)
        assert qc * n * 4 <= tadc.BLOCK_BYTES < 2 * qc * max(n, 1) * 4


@pytest.mark.parametrize("block_bytes", [None, 300 * 4 * 4])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_adc_topk_integer_identical(jx, monkeypatch, k, block_bytes):
    """Integer-valued LUTs with many ties: values and ids identical to the
    reference's ``adc_topk`` (ties to the lower id), in one chunk or in
    chunks of 4 queries."""
    if block_bytes is not None:
        monkeypatch.setattr(tadc, "BLOCK_BYTES", block_bytes)
    jnp = jx["jnp"]
    rng = np.random.default_rng(k)
    n, m, kk, q = 300, 8, 16, 10
    codes = rng.integers(0, kk, (n, m)).astype(np.uint8)
    luts = rng.integers(0, 4, (q, m, kk)).astype(np.float32)
    gv, gi = tadc.adc_topk(T(luts), T(codes), k)
    wv, wi = jx["adc"].adc_topk(jnp.asarray(luts), jnp.asarray(codes), k)
    assert gi.dtype == torch.int32
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gi.numpy(), np.asarray(wi))


def test_adc_topk_float(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(11)
    n, m, kk, q, k = 2000, 16, 256, 7, 10
    codes = rng.integers(0, kk, (n, m)).astype(np.uint8)
    luts = rng.random((q, m, kk), dtype=np.float32)
    gv, gi = tadc.adc_topk(T(luts), T(codes), k)
    wv, wi = jx["adc"].adc_topk(jnp.asarray(luts), jnp.asarray(codes), k)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)
    d = np.sort(np.asarray(jx["adc"].adc_distances(jnp.asarray(luts),
                                                   jnp.asarray(codes))), 1)
    gap = np.diff(d[:, :k + 1], axis=1)
    tie = (gap <= 1e-5 * d[:, 1:k + 1]).any(1)
    same = (gi.numpy() == np.asarray(wi)).all(1)
    assert (same | tie).all()


def test_adc_topk_bounds_k():
    """Any 1 <= k <= N, as the reference's ``adc_topk`` takes (k = 65 and
    k = N equal ``pq_scan_ref`` + ``topk_ref``); k = 0 and k > N raise."""
    g = torch.Generator().manual_seed(5)
    luts = torch.rand((2, 4, 16), generator=g)
    codes = torch.randint(0, 16, (100, 4), generator=g).to(torch.uint8)
    for k in (65, 100):
        got_v, got_i = tadc.adc_topk(luts, codes, k)
        want_v, want_i = ref.topk_ref(ref.pq_scan_ref(luts, codes), k)
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    with pytest.raises(ValueError):
        tadc.adc_topk(luts, codes, 101)
    with pytest.raises(ValueError):
        tadc.adc_topk(luts, codes, 0)


@pytest.mark.parametrize("integer", [True, False])
def test_adc_topk_k100_matches_reference(jx, integer):
    """k = 100 against the reference's ``adc_topk``.  Integer LUTs: values
    and ids identical (ties to the lower id).  Float LUTs: values within
    1e-5; ids equal in every row without a near-tie among its 101
    nearest."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(12)
    n, m, kk, q, k = 1500, 16, 256, 6, 100
    codes = rng.integers(0, kk, (n, m)).astype(np.uint8)
    if integer:
        luts = rng.integers(0, 4, (q, m, kk)).astype(np.float32)
    else:
        luts = rng.random((q, m, kk), dtype=np.float32)
    gv, gi = tadc.adc_topk(T(luts), T(codes), k)
    wv, wi = jx["adc"].adc_topk(jnp.asarray(luts), jnp.asarray(codes), k)
    assert gv.shape == gi.shape == (q, k)
    if integer:
        assert np.array_equal(gv.numpy(), np.asarray(wv))
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        return
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)
    d = np.sort(np.asarray(jx["adc"].adc_distances(jnp.asarray(luts),
                                                   jnp.asarray(codes))), 1)
    gap = np.diff(d[:, :k + 1], axis=1)
    tie = (gap <= 1e-5 * d[:, 1:k + 1]).any(1)
    same = (gi.numpy() == np.asarray(wi)).all(1)
    assert (same | tie).all()


# ----------------------------------------------------------- dispatch


def test_new_ops_on_cpu_run_plain_versions_and_count_nothing():
    before = ops.launch_counts()
    assert {"pq_scan", "decode_attention"} <= set(before)
    q = torch.rand(2, 4, 8)
    k, v = torch.rand(2, 9, 2, 8), torch.rand(2, 9, 2, 8)
    lens = torch.tensor([3, 9], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q, k, v, lens),
                       ref.decode_attention_gqa_ref(q, k, v, lens))
    luts, codes = torch.rand(3, 4, 16), torch.randint(0, 16, (50, 4)).byte()
    assert torch.equal(ops.pq_bulk_scan(luts, codes),
                       ref.pq_scan_ref(luts, codes))
    tadc.adc_topk(luts, codes, 5)
    assert ops.launch_counts() == before


def test_new_kernels_raise_for_other_devices():
    m = torch.empty((2, 4, 8), device="meta")
    with pytest.raises(ValueError):
        ops.decode_attention(m, torch.empty((2, 9, 2, 8), device="meta"),
                             torch.empty((2, 9, 2, 8), device="meta"),
                             torch.empty((2,), device="meta"))
    with pytest.raises(ValueError):
        ops.pq_bulk_scan(m, torch.empty((5, 4), device="meta"))
    # Asking a CUDA wrapper for CPU tensors raises; it never hands back the
    # plain version.
    q, k = torch.rand(2, 4, 8), torch.rand(2, 9, 2, 8)
    with pytest.raises(ValueError):
        da_kernel.decode_attention_cuda(q, k, k, torch.ones(2).int())
    with pytest.raises(ValueError):
        pq_kernel.pq_scan_cuda(torch.rand(2, 4, 16),
                               torch.zeros(5, 4, dtype=torch.uint8))


def test_helpers_default_to_the_card():
    """``pack_filter``, ``constant_alpha`` and the LM's five init helpers
    (``dense_init``, ``embed_init``, ``swiglu_init``, ``gqa_init``,
    ``gqa_init_cache``) run on the card unless the caller asks for the CPU
    (or, for the init helpers, ``"meta"``), like every other entry point of
    the port."""
    allowed = np.ones((2, 40), bool)
    cfg = tattn.GqaConfig(d_model=16, n_heads=4, n_kv_heads=2, d_head=4,
                          qkv_bias=True)
    init = {
        "pack_filter": lambda **kw: tsearch.pack_filter(allowed, 40, **kw),
        "constant_alpha": lambda **kw: tmapping.constant_alpha(5, 1.2, **kw),
        "dense_init": lambda **kw: tlayers.dense_init(None, 4, 3, **kw),
        "embed_init": lambda **kw: tlayers.embed_init(None, 10, 4, **kw),
        "swiglu_init": lambda **kw: tlayers.swiglu_init(
            None, 4, 8, **kw)["w_down"],
        "gqa_init": lambda **kw: tattn.gqa_init(None, cfg, **kw)["bk"],
        "gqa_init_cache": lambda **kw: tattn.gqa_init_cache(
            cfg, 2, 6, **kw)["v"],
    }
    lm = ("dense_init", "embed_init", "swiglu_init", "gqa_init",
          "gqa_init_cache")
    for name, fn in init.items():
        assert fn(device="cpu").device.type == "cpu", name
        if name in lm:
            assert fn(device="meta").device.type == "meta", name
        if torch.cuda.is_available():
            assert fn().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError):
                fn()


# ------------------------------------------------------------ on the card


def _count(name):
    return ops.launch_counts()[name]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d", DA_SHAPES + [(4, 28, 4, 4096, 128),
                                                      (8, 28, 4, 160, 128),
                                                      (1, 28, 4, 70000, 128),
                                                      (2, 32, 2, 333, 256),
                                                      (2, 14, 2, 257, 24),
                                                      (1, 7, 1, 999, 200),
                                                      (2, 4, 2, 333, 48)])
def test_decode_attention_kernel_matches_plain_on_card(card, b, hq, hkv, s,
                                                       d):
    g = torch.Generator(device=card).manual_seed(s + hq)
    tdt = torch.bfloat16
    q = torch.randn((b, hq, d), generator=g, device=card).to(tdt)
    k = torch.randn((b, s, hkv, d), generator=g, device=card).to(tdt)
    v = torch.randn((b, s, hkv, d), generator=g, device=card).to(tdt)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=card,
                         dtype=torch.int32)
    lens[0] = 1
    lens[-1] = s
    before = _count("decode_attention")
    got = ops.decode_attention(q, k, v, lens)
    again = ops.decode_attention(q, k, v, lens)
    want = ref.decode_attention_gqa_ref(q, k, v, lens)
    torch.cuda.synchronize()
    assert _count("decode_attention") == before + 2
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    assert torch.equal(got, again)                  # deterministic
    edge = torch.tensor([0] + [s + 5] * (b - 1), dtype=torch.int32,
                        device=card)
    got = ops.decode_attention(q, k, v, edge)
    want = ref.decode_attention_gqa_ref(q, k, v, edge)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.gpu
def test_decode_attention_splits_fill_the_card(card):
    """The splits the kernel's library picks fill the card's resident block
    slots in one wave: no second wave, and no room left for one more split
    of every head.  The slots are the splits of one (row, head) over a
    long cache, a whole number of blocks per streaming multiprocessor
    where they stay under the cap of 1024 splits (small head dims fit
    more blocks than that)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, hkv, s, d in [(16, 4, 32768, 128), (1, 4, 524288, 128),
                         (8, 4, 160, 128), (3, 1, 130, 64),
                         (200, 8, 64, 128), (2, 2, 333, 256),
                         (2, 2, 333, 8), (1, 1, 99, 200)]:
        slots = da_kernel.num_splits(1, 1, 16 * 2**20, d)
        sp = da_kernel.num_splits(b, hkv, s, d)
        tiles = -(-s // 16)
        assert 1 <= sp <= min(tiles, 1024)
        if slots == 1024:
            continue
        assert slots % sms == 0
        assert b * hkv * sp <= max(slots, b * hkv)
        assert sp == tiles or b * hkv * (sp + 1) > slots
    if sms == 132:                    # an H100 SXM: two blocks an SM at 128
        assert da_kernel.num_splits(16, 4, 32768, 128) == 4
        assert da_kernel.num_splits(1, 4, 524288, 128) == 66


@pytest.mark.gpu
def test_decode_attention_kernel_refuses_other_head_dims(card):
    q = torch.rand((1, 4, 12), device=card)
    k = torch.rand((1, 9, 2, 12), device=card).bfloat16()
    lens = torch.ones(1, device=card, dtype=torch.int32)
    with pytest.raises(ValueError):
        da_kernel.decode_attention_cuda(q, k, k, lens)
    q, k = torch.rand((1, 4, 264), device=card), k.new_zeros((1, 9, 2, 264))
    with pytest.raises(ValueError):
        da_kernel.decode_attention_cuda(q, k, k, lens)


@pytest.mark.gpu
def test_decode_attention_kernel_takes_only_a_bfloat16_cache(card):
    q = torch.rand((1, 4, 8), device=card)
    k = torch.rand((1, 9, 2, 8), device=card)
    with pytest.raises(ValueError):
        da_kernel.decode_attention_cuda(q, k, k, torch.ones(1, device=card,
                                                            dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,k,q", PQ_SHAPES + [(1_000_003, 16, 256, 6),
                                                 (4097, 32, 256, 9),
                                                 (777, 64, 256, 4),
                                                 (5000, 7, 33, 1)])
def test_pq_scan_kernel_matches_plain_on_card(card, n, m, k, q):
    g = torch.Generator(device=card).manual_seed(n + m)
    codes = torch.randint(0, k, (n, m), generator=g, device=card,
                          dtype=torch.uint8)
    luts_i = torch.randint(0, 64, (q, m, k), generator=g, device=card).float()
    luts_f = torch.rand((q, m, k), generator=g, device=card)
    before = _count("pq_scan")
    got_i, got_f = ops.pq_bulk_scan(luts_i, codes), ops.pq_bulk_scan(luts_f,
                                                                     codes)
    want_i, want_f = ref.pq_scan_ref(luts_i, codes), ref.pq_scan_ref(luts_f,
                                                                    codes)
    torch.cuda.synchronize()
    assert _count("pq_scan") == before + 2
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_f, want_f, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_adc_topk_on_card_matches_cpu(card, monkeypatch):
    """Through the kernels on the card, in chunks of 4 queries, equal to the
    plain path on the CPU on integer LUTs."""
    monkeypatch.setattr(tadc, "BLOCK_BYTES", 50_000 * 4 * 4)
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 256, (50_000, 16), generator=g).to(torch.uint8)
    luts = torch.randint(0, 16, (10, 16, 256), generator=g).float()
    before = ops.launch_counts()
    gv, gi = tadc.adc_topk(luts.to(card), codes.to(card), 10)
    after = ops.launch_counts()
    cv, ci = tadc.adc_topk(luts, codes, 10)
    assert after["pq_scan"] - before["pq_scan"] == 3
    assert after["topk"] - before["topk"] == 3
    assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci)


@pytest.mark.gpu
def test_decode_attention_kernel_holds_large_logits_on_card(card):
    """Logits near 30 (|q.k| / sqrt(d)): the kernel's hi + lo split of q and
    P keeps 3e-4, where q rounded to bfloat16 alone would not; two launches
    agree bit for bit."""
    b, hq, hkv, s, d = 4, 28, 4, 4096, 128
    g = torch.Generator(device=card).manual_seed(9)
    k = torch.randn((b, s, hkv, d), generator=g, device=card).bfloat16()
    v = torch.randn((b, s, hkv, d), generator=g, device=card).bfloat16()
    q = 8.0 * torch.randn((b, hq, d), generator=g, device=card)
    lens = torch.tensor([s, 101, 3000, 1], dtype=torch.int32, device=card)
    want = ref.decode_attention_gqa_ref(q, k, v, lens)
    logits = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, hkv, -1, d),
                          k.float()) / d ** 0.5
    assert float(logits.abs().max()) > 30.0
    rounded = ref.decode_attention_gqa_ref(q.bfloat16().float(), k, v, lens)
    assert float((rounded - want).abs().max()) > 3e-4   # the case bites
    got = ops.decode_attention(q, k, v, lens)
    again = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 5, 256])
@pytest.mark.parametrize("m", [8, 16, 64])
@pytest.mark.parametrize("kk", [16, 256])
def test_pq_scan_kernel_sweep_on_card(card, kk, m, q):
    """K = 16 / 256; M = 8 (the plain kernel), 16 (one pass of the skewed
    walk) and 64 (four passes, a row's sum stored and read back between
    them); Q = 1 / 5 / 256 (partial groups of 4); N = 3001, not a multiple
    of a block's rows; random codes with all-zero rows: bit for bit on
    integer LUTs, within 1e-5 on float LUTs."""
    n = 3001
    g = torch.Generator(device=card).manual_seed(kk * m + q)
    codes = torch.randint(0, kk, (n, m), generator=g, device=card,
                          dtype=torch.uint8)
    codes[:37] = 0
    luts_i = torch.randint(-64, 64, (q, m, kk), generator=g,
                           device=card).float()
    luts_f = torch.rand((q, m, kk), generator=g, device=card)
    before = _count("pq_scan")
    got_i, got_f = ops.pq_bulk_scan(luts_i, codes), ops.pq_bulk_scan(luts_f,
                                                                     codes)
    want_i, want_f = ref.pq_scan_ref(luts_i, codes), ref.pq_scan_ref(luts_f,
                                                                    codes)
    torch.cuda.synchronize()
    assert _count("pq_scan") == before + 2
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_f, want_f, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_adc_topk_k100_on_card_matches_cpu(card):
    """Recall@100's k through ``pq_scan`` and ``topk`` on the card, equal
    to the plain path on the CPU on integer LUTs."""
    g = torch.Generator().manual_seed(4)
    codes = torch.randint(0, 256, (50_000, 16), generator=g).to(torch.uint8)
    luts = torch.randint(0, 16, (10, 16, 256), generator=g).float()
    before = ops.launch_counts()
    gv, gi = tadc.adc_topk(luts.to(card), codes.to(card), 100)
    after = ops.launch_counts()
    cv, ci = tadc.adc_topk(luts, codes, 100)
    assert after["pq_scan"] - before["pq_scan"] == 1
    assert after["topk"] - before["topk"] == 1
    assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci)
