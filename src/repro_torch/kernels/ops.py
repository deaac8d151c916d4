"""Device-dispatching wrappers for the port's kernels.

Dispatch is by the tensors' device only: a tensor on the CPU runs the plain
PyTorch version (:mod:`repro_torch.kernels.ref`); a tensor on a CUDA device
launches the hand-written kernel, which raises if it cannot build or launch
or the card is not sm_90.  Nothing falls back from the kernel to the plain
version.  Library code calls these wrappers only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import beam_step as _beam
from repro_torch.kernels import ref as _ref


def beam_step(state, ctxs, adj, table, budgets, hop_limits, *, kind: str,
              active_count: torch.Tensor | None = None):
    """One fused hop of the batched beam walk (state layout as in
    :func:`repro_torch.kernels.ref.beam_step_ref`).

    On the card the state is updated in place and returned; on the CPU a
    new state is returned.  Callers use the return value either way.
    ``active_count`` (one int32, optional) gains one for each lane that can
    still move after the hop — the counter the hop loop polls.
    """
    dev = state[0].device
    if dev.type == "cuda":
        return _beam.beam_step_cuda(state, ctxs, adj, table, budgets,
                                    hop_limits, kind=kind,
                                    active_count=active_count)
    if dev.type != "cpu":
        raise ValueError(f"beam_step has no implementation for device {dev}")
    out = _ref.beam_step_ref(state, ctxs, adj, table, budgets, hop_limits,
                             kind=kind)
    if active_count is not None:
        active_count += _ref.lane_active(out[0], out[2], out[4], budgets,
                                         hop_limits).sum(dtype=torch.int32)
    return out


def launch_counts() -> dict[str, int]:
    """Kernel launches per kind since the last :func:`reset_launch_counts`."""
    return dict(_beam.launches)


def reset_launch_counts() -> None:
    _beam.reset_launch_counts()
