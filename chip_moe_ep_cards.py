#!/usr/bin/env python3
"""[lm-train-moe-ep] over every visible card, without the rest of the
smoke: the gpu tests of ``tests/test_torch_moe_ep.py`` (one of them needs
two cards or more), then ``chip_smoke.lm_train_moe_ep`` twice: its meshes
on the first card alone, then over every card (a rank a card on four).
The two runs' first-step losses must be equal bit for bit: the forward
computes the same products on each card, whatever card holds a rank.

    python3 chip_moe_ep_cards.py              # e.g. on a host with four H100s

It prints the test summary, the number of cards and each
[lm-train-moe-ep] line of both runs (the gates, the steps, the bytes a step
copies between cards, each card's peak memory), and exits non-zero if a
test, a gate or the comparison fails.  Needs a card.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                        "--noconftest", "-x", "-p", "no:cacheprovider",
                        "tests/test_torch_moe_ep.py"],
                       cwd=ROOT, env=env, capture_output=True, text=True)
    print(r.stdout[-6000:], r.stderr[-3000:], flush=True)
    print(f"[cards] gpu tests rc={r.returncode} in {time.time() - t0:.1f}s",
          flush=True)

    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        print("chip_moe_ep_cards: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all(ops.LIBRARIES)
    dev = torch.device("cuda", 0)
    card = cs.gpu_name_power()
    n = torch.cuda.device_count()
    print(f"[cards] {n} cards; {card}", flush=True)
    t0 = time.time()
    _, one = cs.lm_train_moe_ep(dev, card, 0, None, devices=[dev])
    t1 = time.time()
    _, every = cs.lm_train_moe_ep(dev, card, 0, None)
    print(f"[cards] one card {t1 - t0:.1f}s, every card {time.time() - t1:.1f}"
          f"s; first-step loss {one!r} on one card, {every!r} over {n} "
          f"cards: {'equal' if one == every else 'DIFFERENT'}", flush=True)
    if one != every:
        return 1
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
