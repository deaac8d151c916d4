"""Checkpoints: save, restore, retention and an asynchronous saver (port of
:mod:`repro.training.checkpoint`).

Layout, the reference's: one directory per step (``step_%08d``), one
``.npy`` per tensor of the tree (its path, sanitised, as the file name)
and a JSON manifest (step, each leaf's name, shape and logical dtype, and
``extra``).  bfloat16 is stored as its ``uint16`` bits.  A checkpoint is
written into ``.tmp_step_*`` and published by an atomic rename, so a
partial one is never visible.  The tree is any nest of dicts, lists,
dataclasses (a :class:`~repro_torch.training.train_step.TrainState`) and
tensors; ``None`` holds no leaves.

The reference's ``shardings=`` (an elastic restore onto another TPU mesh)
has no counterpart on one card: every leaf is restored onto the device
and dtype of the matching leaf of the target tree.

:class:`AsyncCheckpointer` copies the tree to the host before its writer
thread starts, so training may update the tensors in place meanwhile.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.training.optimizer import flatten, tree_map

Params = Any

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _leaf_name(path) -> str:
    raw = "/".join(str(p) for p in path)
    return _SAFE.sub("_", raw).strip("_") or "leaf"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later in-place updates of ``t`` do not reach."""
    return t.detach().to("cpu", copy=True)


def save_checkpoint(directory: str | pathlib.Path, step: int, tree: Params,
                    extra: dict | None = None) -> pathlib.Path:
    directory = pathlib.Path(directory)
    out = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for path, leaf in flatten(tree):
        name = _leaf_name(path)
        t = leaf.detach().cpu()
        logical = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: store the raw bits.
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        np.save(tmp / f"{name}.npy", arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": logical})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)  # atomic publish: partial checkpoints never visible
    return out


def _steps(directory: pathlib.Path) -> list[int]:
    return sorted(int(p.name.split("_")[1])
                  for p in directory.glob("step_*"))


def restore_checkpoint(directory: str | pathlib.Path, target_tree: Params,
                       step: int | None = None) -> tuple[Params, int]:
    """Restore into the structure of ``target_tree`` (the latest step
    unless ``step`` is given); each leaf on its target's device and in its
    dtype.  Returns (tree, step)."""
    directory = pathlib.Path(directory)
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    src = directory / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    dtypes = {m["name"]: m["dtype"] for m in manifest["leaves"]}
    new_leaves = []
    for path, leaf in flatten(target_tree):
        name = _leaf_name(path)
        arr = np.load(src / f"{name}.npy")
        if dtypes.get(name) == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {name}: shape "
                             f"{tuple(t.shape)}, the target's "
                             f"{tuple(leaf.shape)}")
        new_leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), target_tree), step


def latest_step(directory: str | pathlib.Path) -> int | None:
    steps = _steps(pathlib.Path(directory))
    return steps[-1] if steps else None


def prune_old(directory: str | pathlib.Path, keep: int = 3) -> None:
    """Rolling window of checkpoints (disk hygiene on long runs)."""
    steps = sorted(pathlib.Path(directory).glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p)


class AsyncCheckpointer:
    """Background-thread checkpoint writer (training never blocks on
    disk).  A write that failed raises from the next :meth:`wait` (or
    :meth:`save`, which waits first)."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, directory, step: int, tree: Params, extra=None) -> None:
        self.wait()
        # Copy to the host *before* the thread starts, so the next step
        # may update the tensors in place.
        host_tree = tree_map(_host, tree)

        def write():
            try:
                save_checkpoint(directory, step, host_tree, extra)
            except BaseException as e:  # handed to wait()
                self._error = e

        self._thread = threading.Thread(target=write)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
