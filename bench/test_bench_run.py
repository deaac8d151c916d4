"""A whole run of each cell at a tiny size on the CPU (the harness's look
for a card skipped): sound, it is correct; with the timed path broken
underneath, or with the bfloat16 control in the program's place, it is
not."""
import numpy as np
import pytest
import torch

from bench import _tiny, control, faults, harness, readings, spec

CELLS = [w["name"] for w in spec.load_benchmark(_tiny.ROOT)["workloads"]]


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, traced):
    out = _tiny.run(workload, traced=traced)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-2:] == ["checks", "_check_lines"]
    cell = spec.resolve(_tiny.ROOT, workload)
    if traced:
        # No device events on the CPU: the device's readers return nothing.
        assert set(out["metrics"]) == {m["name"] for m in cell.per_layer} - {
            "beam_step_roofline", "device_idle_share", "device_ms_per_batch",
            "host_syncs_per_batch"}
        assert out["device"]["window_s"] > 0
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in out["metrics"].values())


def _break_window(monkeypatch, fault: str):
    """Plant ``fault`` (``bench/faults.py``) only once the window starts
    (set-up stays sound)."""
    window = harness._window

    def broken(*args, **kw):
        with faults.plant(fault):
            return window(*args, **kw)

    monkeypatch.setattr(harness, "_window", broken)


@pytest.mark.parametrize("workload", CELLS)
def test_walk_that_returns_its_state_unchanged_is_caught(workload,
                                                         monkeypatch):
    _break_window(monkeypatch, "walk_unchanged")
    out = _tiny.run(workload)
    assert not out["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_each_batch_left_out_is_caught(workload, monkeypatch):
    _break_window(monkeypatch, "half_batch")
    out = _tiny.run(workload)
    assert not out["correct"]
    assert out["failed"] >= out["attempted"] // 2


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_where_it_is_produced_is_caught(workload,
                                                       monkeypatch):
    _break_window(monkeypatch, "answer_altered")
    out = _tiny.run(workload)
    assert not out["correct"]
    checks = out["checks"]
    assert (checks["d2_rel_err"]["value"] > checks["d2_rel_err"]["limit"]
            or checks["bad_answers"]["value"] > 0)


@pytest.mark.parametrize("workload", CELLS)
def test_answers_of_another_query_are_caught_by_the_recall_floor(
        workload, monkeypatch):
    # Valid, distinct ids with their true distances: only recall sees it.
    _break_window(monkeypatch, "other_query_rows")
    out = _tiny.run(workload)
    failed = [line.split()[1].rstrip(":") for line in out["_check_lines"]
              if line.endswith("FAILED")]
    assert failed == ["recall_at_10"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_fails_a_check(workload):
    checks = control.control_checks(_tiny.ROOT, workload, 11,
                                    torch.device("cpu"),
                                    _tiny.config(workload))
    assert not all(c["ok"] for c in checks.values())
    failed = [n for n, c in checks.items() if not c["ok"]]
    assert "d2_rel_err" in failed and "pq_code_excess" in failed, checks


@pytest.mark.parametrize("workload", CELLS)
def test_readings_of_sound_and_planted_runs(workload):
    got = list(readings.readings(
        _tiny.ROOT, workload, [2**31 + 5, 3], ["walk_unchanged",
                                                "other_query_rows"],
        _tiny.SECONDS, torch.device("cpu"), config=_tiny.config(workload),
        traffic_mix=_tiny.traffic(workload)))
    assert [(r["seed"], r["fault"]) for r in got] == [
        (s, f) for s in (2**31 + 5, 3)
        for f in ("none", "walk_unchanged", "other_query_rows")]
    assert [r["correct"] for r in got] == [True, False, False] * 2
    # Every seed serves the same index.
    assert {r["work"]["adj_digest"] for r in got} == {
        got[0]["work"]["adj_digest"]}


def test_same_data_seed_same_inputs():
    cfg = _tiny.config(CELLS[0])
    data = spec.load_reader(_tiny.ROOT, "datasets", cfg["data"]["generator"])
    cpu = torch.device("cpu")
    a = data.generate(dict(cfg["data"], seed=2**31 + 9), cpu)
    b = data.generate(dict(cfg["data"], seed=2**31 + 9), cpu)
    c = data.generate(dict(cfg["data"], seed=2**31 + 10), cpu)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (1500, cfg["data"]["d"])
    norms = np.linalg.norm(data.generate(
        dict(cfg["data"], unit_norm=True), cpu)[0].numpy(), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


@pytest.mark.gpu
def test_tiny_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    out = harness.run_cell(_tiny.ROOT, CELLS[0], 5, _tiny.SECONDS, True,
                           torch.device("cuda", 0), time.perf_counter(),
                           config=_tiny.config(CELLS[0]),
                           traffic_mix=_tiny.traffic(CELLS[0]))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert "beam_step_roofline" in out["metrics"]
