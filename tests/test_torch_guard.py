"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or the JAX package ``repro``."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "repro") or name.startswith(("jax.", "repro.")):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke

from repro_torch import serving
from repro_torch.core import build, search
from repro_torch.data import make_dataset
from repro_torch.index import build_tiered_index
x, q = make_dataset("tiny-uniform", device="cpu", n=300)
g = build.build_mcgi(x, build.BuildConfig(degree=8, beam_width=16, batch=64,
                                          max_hops=32), device="cpu")
idx = build_tiered_index(x, g, m_pq=4, device="cpu")
budget = search.AdaptiveBeamBudget(l_min=4, l_max=16)
eng = serving.SearchEngine(serving.TieredBackend(idx, device="cpu"), budget,
                           k=5)
res = eng.search(q[:8].numpy())
assert res.ids.shape == (8, 5) and (res.ids >= 0).all()
import pathlib
from repro_torch.index import load_index, open_or_build_slow_tier, save_index
save_index(pathlib.Path(sys.argv[1]) / "i.npz", idx, version=2)
tier = open_or_build_slow_tier(pathlib.Path(sys.argv[1]) / "d.blocks",
                               load_index(pathlib.Path(sys.argv[1]) / "i.npz",
                                          device="cpu"),
                               cache_nodes=32, pin_nodes=8, hot_nodes=16)
disk = serving.SearchEngine(
    serving.TieredBackend(idx, slow_tier=tier, device="cpu"), budget, k=5)
assert (list(disk.search_batches([q[:8].numpy()]))[0].ids == res.ids).all()
disk.close()
from repro_torch.core import distance
_, gt = distance.brute_force_topk(q[:32], x, 5)
fit = eng.recalibrate(q[:32].numpy(), gt.numpy(), recall_target=0.5,
                      joint=True, sample=16)
assert fit.l_min is not None and eng.budget_cfg.lam == fit.lam
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               or m == "repro" for m in sys.modules)
print("ok")
"""


def test_port_runs_with_jax_and_repro_blocked(tmp_path):
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
