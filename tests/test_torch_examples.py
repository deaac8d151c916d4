"""The five examples on the PyTorch port (``examples/torch_*.py``): each
``main`` on the CPU at a tiny size, and each source free of ``jax`` and
``repro`` imports."""
import importlib.util
import os
import re

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
NAMES = ("torch_quickstart", "torch_rag_retrieval", "torch_serve_e2e",
         "torch_distributed_serve", "torch_train_lm")
FORBIDDEN = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)", re.M)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_the_reference(name):
    with open(os.path.join(EXAMPLES, f"{name}.py")) as f:
        src = f.read()
    assert not FORBIDDEN.search(src)
    assert "def main(argv=None)" in src and '"--device", default="cuda"' in src


def test_quickstart_on_cpu(capsys):
    out = _load("torch_quickstart").main(["--device", "cpu", "--n", "400"])
    text = capsys.readouterr().out
    assert "MCGI built" in text and "vamana L=32" in text
    assert out["mcgi_L64"] >= 0.95 and out["vamana_L32"] >= 0.9
    assert out["mcgi_L16"] <= out["mcgi_L64"]


def test_rag_retrieval_on_cpu(capsys):
    out = _load("torch_rag_retrieval").main(
        ["--device", "cpu", "--docs", "384", "--seq", "8"])
    text = capsys.readouterr().out
    assert "namespace-scoped" in text and "out-of-namespace results = 0" in text
    assert out["recall"] >= 0.8 and 0.0 <= out["purity"] <= 1.0


@pytest.mark.parametrize("flags", [
    [], ["--adaptive", "--buckets", "2", "--calibrate", "--joint"]])
def test_serve_e2e_on_cpu(tmp_path, capsys, flags):
    out = _load("torch_serve_e2e").main(
        ["--device", "cpu", "--n", "1200", "--seconds", "1",
         "--offered-qps", "300", "--disk", str(tmp_path / "s.blocks")]
        + flags)
    text = capsys.readouterr().out
    assert "disk tier: hit_rate=" in text and out["served"] > 0
    assert out["recall"] >= 0.85
    if flags:
        assert "calibrated lam=" in text


def test_serve_e2e_refuses_calibrate_without_adaptive():
    with pytest.raises(SystemExit):
        _load("torch_serve_e2e").main(["--device", "cpu", "--calibrate"])


def test_distributed_serve_on_cpu(capsys):
    out = _load("torch_distributed_serve").main(["--device", "cpu",
                                                 "--n", "1200"])
    text = capsys.readouterr().out
    assert "staged == monolithic step (bit-identical d2)" in text
    assert out["all_shards"] >= 0.9 and out["staged"] >= 0.9
    assert out["shard5_dropped"] < out["all_shards"]


def test_train_lm_on_cpu(capsys):
    """The 100M-parameter LM for two steps: a finite loss, a checkpoint at
    the last step and the resume drill restoring it bit for bit."""
    out = _load("torch_train_lm").main(
        ["--device", "cpu", "--steps", "2", "--batch", "1", "--seq", "16"])
    text = capsys.readouterr().out
    assert "81M params" in text and "resume drill: restored step 2" in text
    assert out["restored_step"] == 2 and out["restored_equal"]
    assert out["first_loss"] > 0 and out["tokens_per_s"] > 0
