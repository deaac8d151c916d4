"""The reference held to brute force in NumPy on tiny seeded sets."""
import numpy as np
import pytest
import torch

from bench.reference import graph, knn, pq


@pytest.fixture
def data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 12)).astype(np.float32)
    q = rng.normal(size=(20, 12)).astype(np.float32)
    return x, q


def _brute(x, q, k):
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64))
         ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


def test_exact_topk_matches_brute_force(data, monkeypatch):
    x, q = data
    monkeypatch.setattr(knn, "BLOCK_ELEMENTS", 300 * 7)   # 7 queries a block
    ids, d2 = knn.exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10)
    want_ids, want_d2 = _brute(x, q, 10)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=1e-12, atol=1e-12)


def test_pair_d2_and_invalid_ids(data):
    x, q = data
    ids = torch.tensor([[0, 5, -1], [299, 300, 7]])
    got = knn.pair_d2(torch.from_numpy(x), torch.from_numpy(q),
                      torch.tensor([3, 9]), ids).numpy()
    for r, qi in enumerate((3, 9)):
        for c in range(3):
            i = int(ids[r, c])
            if 0 <= i < 300:
                want = ((q[qi].astype(np.float64) - x[i]) ** 2).sum()
                assert got[r, c] == pytest.approx(want, rel=1e-12)
            else:
                assert np.isnan(got[r, c])


def test_recall_hits():
    ids = torch.tensor([[1, 2, 3], [4, 5, 6]])
    gt = torch.tensor([[3, 2, 9], [7, 8, 9]])
    assert knn.recall_hits(ids, gt).tolist() == [2, 0]


def test_bfloat16_topk_departs_from_float64(data):
    x, q = data
    x = x + 40.0          # large norms: the expanded form loses the distance
    q = q + 40.0
    lo = knn.exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10,
                        dtype=torch.bfloat16)[0]
    hi = knn.exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10)[0]
    assert knn.recall_hits(lo, hi).float().mean() < 9.0


def _codebook(rng, m=4, k=16, dsub=3):
    return torch.from_numpy(rng.normal(size=(m, k, dsub)).astype(np.float32))


def test_encode_matches_brute_force_and_pads():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(50, 10)).astype(np.float32))
    cb = _codebook(rng)                                  # D padded 10 -> 12
    got = pq.encode(x, cb).numpy()
    xp = np.pad(x.numpy(), ((0, 0), (0, 2))).reshape(50, 4, 1, 3)
    want = ((xp - cb.numpy()[None]) ** 2).sum(-1).argmin(-1)
    np.testing.assert_array_equal(got, want)


def test_code_excess_reads_zero_for_nearest_codes_and_more_otherwise():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(60, 12)).astype(np.float32))
    cb = _codebook(rng)
    codes = pq.encode(x, cb)
    assert pq.code_excess(x, cb, codes) == 0.0
    wrong = codes.clone()
    wrong[7, 2] = (wrong[7, 2] + 1) % 16
    assert pq.code_excess(x, cb, wrong) > 1e-3
    wrong[0, 0] = 16
    assert pq.code_excess(x, cb, wrong) == float("inf")
    assert pq.code_excess(x, cb, codes[:, :3]) == float("inf")


def _sound_graph(n=40, r=5, seed=0):
    rng = np.random.default_rng(seed)
    adj = np.full((n, r), -1, dtype=np.int32)
    for u in range(n):
        nb = rng.choice([v for v in range(n) if v != u], size=r - 1,
                        replace=False)
        adj[u, :r - 1] = nb
    return torch.from_numpy(adj)


@pytest.mark.parametrize("fault,count", [
    ("none", 0), ("out_of_range", 1), ("self_loop", 1), ("repeat", 1),
    ("empty_row", 1), ("entry", 1), ("width", 40)])
def test_bad_entries_counts_each_fault(fault, count):
    adj, entry, degree = _sound_graph(), 0, 5
    if fault == "out_of_range":
        adj[3, 4] = 40
    elif fault == "self_loop":
        adj[5, 4] = 5
    elif fault == "repeat":
        adj[6, 4] = adj[6, 0]
    elif fault == "empty_row":
        adj[8] = -1
    elif fault == "entry":
        entry = 40
    elif fault == "width":
        degree = 6
    assert graph.bad_entries(adj, entry, degree) == count
