"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
data-driven lookup: every name resolves to a file, and new files with new
entries are found with no edit to a file that exists."""
import json
import pathlib
import shutil

import numpy as np
import pytest

from bench import costs, spec, trace, traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
TEXT_LIMIT = 200


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_only_allowed_characters(name):
    assert spec.NAME_RE.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert spec.UNIT_RE.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "bound", "layer", "moves",
               "workloads"}
    assert set(metric) <= allowed
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= TEXT_LIMIT


def test_no_two_entries_share_a_name():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")
    for group in ("configs", "workloads"):
        for entry in BENCH[group]:
            assert 1 <= len(entry["why"]) <= TEXT_LIMIT
            assert "\n" not in entry["why"] and "\t" not in entry["why"]
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_names_an_end_to_end_metric_of_each_of_its_cells(metric):
    for cell in metric.get("workloads", CELLS):
        reported = [m["name"] for m in spec.resolve(ROOT, cell).end_to_end]
        assert metric["moves"] in reported, (metric["name"], cell)


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_files(workload):
    cell = spec.resolve(ROOT, workload)
    cfg = cell.config
    assert spec.reader_path(ROOT, "datasets",
                            cfg["data"]["generator"]).exists()
    assert spec.reader_path(ROOT, "systems", cfg["system"]).exists()
    for name in cfg["correct"]:
        assert hasattr(spec.load_reader(ROOT, "checks", name), "reading")
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(spec.load_reader(ROOT, "metrics", m["name"]), "read")
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    traffic.check(cell.traffic)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_names_its_cuts(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["reduced"] == config["reduced"]
    assert config["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))


# The published sizes of each source: N, D and the query set.
SOURCE_SIZES = {"sift1m": (1_000_000, 128, 10_000),
                "glove100": (1_183_514, 100, 10_000)}


@pytest.mark.parametrize("name", sorted(SOURCE_SIZES))
def test_configs_keep_the_source_sizes(name):
    files = {c["name"]: c["file"] for c in BENCH["configs"]}
    data = json.loads((ROOT / files[name]).read_text())["data"]
    assert (data["n"], data["d"], data["queries"]) == SOURCE_SIZES[name]


def test_new_configuration_traffic_metric_and_check_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "bench/configs/sift1m.json").read_text())
    cfg["name"] = "sift1m-copy"
    cfg["correct"]["always_one"] = {"sense": "max", "limit": 1}
    (tmp_path / "bench/configs/sift1m-copy.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "bench/traffic/b10k.json").read_text())
    (tmp_path / "bench/traffic/b5k.json").write_text(
        json.dumps(dict(mix, batch=5000)))
    (tmp_path / "bench/metrics/queries_seen.py").write_text(
        "def read(run):\n    return 1.0\n")
    (tmp_path / "bench/checks/always_one.py").write_text(
        "def reading(ctx):\n    return 1.0\n")
    bench["configs"].append(dict(bench["configs"][0], name="sift1m-copy",
                                 file="bench/configs/sift1m-copy.json"))
    bench["workloads"].append({"name": "sift1m-copy.b5k",
                               "config": "sift1m-copy", "traffic": "b5k",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "queries_seen", "unit": "queries",
                               "better": "higher", "source": "host_clock",
                               "layer": "client", "moves": "qps",
                               "workloads": ["sift1m-copy.b5k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.resolve(tmp_path, "sift1m-copy.b5k")
    assert cell.config["name"] == "sift1m-copy"
    assert cell.traffic["batch"] == 5000
    assert [m["name"] for m in cell.per_layer][-1] == "queries_seen"
    assert spec.load_reader(tmp_path, "metrics", "queries_seen").read(None) == 1
    assert spec.load_reader(tmp_path, "checks", "always_one").reading(None) == 1
    assert "queries_seen" not in [
        m["name"] for m in spec.resolve(tmp_path, "sift1m.b10k").per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_traffic_repeats_by_seed_and_covers_the_pool():
    mix = {"batch": 30, "warmup_batches": 0, "trace_skip_batches": 0, "trace_batches": 1}
    a, b = traffic.batch_indices(50, mix, 2**33 + 1), \
        traffic.batch_indices(50, mix, 2**33 + 1)
    first = [next(a) for _ in range(5)]
    assert all(np.array_equal(x, next(b)) for x in first)
    assert all(x.shape == (30,) for x in first)
    flat = np.concatenate(first)
    for p in range(3):
        assert sorted(flat[50 * p:50 * (p + 1)]) == list(range(50))
    other = next(traffic.batch_indices(50, mix, 3))
    assert not np.array_equal(other, first[0])


def test_traffic_refuses_an_unknown_loop():
    with pytest.raises(ValueError):
        traffic.check({"loop": "open", "batch": 1, "warmup_batches": 0,
                       "trace_skip_batches": 0, "trace_batches": 1})
    with pytest.raises(ValueError):
        traffic.check({"batch": 0, "warmup_batches": 0,
                       "trace_skip_batches": 0, "trace_batches": 1})


class _Kind:
    def __init__(self, name):
        self.name = name


class _Range:
    def __init__(self, a, b):
        self.start, self.end = a, b


class _Event:
    def __init__(self, name, device, a, b):
        self.name, self.device_type = name, _Kind(device)
        self.time_range = _Range(a, b)


def test_trace_digest_unions_device_time_and_names_gaps():
    events = [
        _Event("aten::copy_", "CPU", 0, 100),
        _Event("cudaStreamSynchronize", "CPU", 40, 60),
        _Event("cudaEventSynchronize", "CPU", 70, 75),
        _Event("void beam_walk_kernel<1, false>(int, int)", "CUDA", 10, 30),
        _Event("void beam_walk_kernel<1, false>(int, int)", "CUDA", 20, 40),
        _Event("Memcpy DtoH", "CUDA", 80, 90),
    ]
    d = trace.digest(events, batches=2)
    assert d.window_s == pytest.approx(100e-6)
    assert d.busy_s == pytest.approx(40e-6)           # [10, 40] and [80, 90]
    assert d.syncs == 2 and d.batches == 2
    assert d.device_seconds("beam_walk_kernel<1") == pytest.approx(40e-6)
    assert d.device_ops[0] == ["beam_walk_kernel<1, false>",
                               pytest.approx(40e-6)]
    assert d.idle_gaps == [["cudaStreamSynchronize", pytest.approx(40e-6)]]


def test_beam_walk_bytes_and_peaks():
    assert costs.beam_walk_pq_bytes(2, 10, 100, 64, 16, 256) == \
        10 * 64 * 4 + 100 * 16 + 2 * 16 * 256 * 4
    assert costs.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert costs.peak("cpu", "hbm_bytes_per_s") is None
