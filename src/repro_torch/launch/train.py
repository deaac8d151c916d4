"""Training launcher (port of :mod:`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 200 --batch 8 --seq 128 [--smoke | --full] [--ckpt-dir DIR] \
        [--compress-grads] [--resume] [--device cuda]

Trains an LM arch of the registry on the card (``--device cpu`` on the
host): float32 master weights drawn from a ``torch.Generator`` seeded 0
(the reference's ``init_lm`` keeps float32 too; the random bits are not
the reference's), compute in the config's dtype, AdamW with the WSD
schedule for minicpm and cosine otherwise, synthetic Zipfian batches.
The fault-tolerance loop is the reference's: periodic async checkpoints,
resume from the latest, rolling retention of three.  At full width
(``--full``) minicpm-2b trains at train_4k's sequence with
``--seq 4096`` and a batch that fits one card (``chip_smoke.py``'s
[lm-train] prints the one it uses).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import base as cfg_base
    from repro_torch.models import transformer as tfm
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_step as ts_mod
    from repro_torch.training.data import LmBatches

    dev = resolve_device(args.device)
    spec = cfg_base.get(args.arch)
    if spec.family != "lm":
        raise SystemExit("train.py drives LM archs")
    cfg = spec.smoke_config if args.smoke else spec.config

    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_lm(cfg, gen, device=dev, dtype=torch.float32)
    opt_cfg = train_config(args.arch, args.lr, args.steps)
    step_fn = ts_mod.make_train_step(
        lambda p, b: tfm.lm_loss(cfg, p, b), opt_cfg,
        compress_grads=args.compress_grads)
    state = ts_mod.init_train_state(params,
                                    compress_grads=args.compress_grads)

    start = 0
    checkpointer = ckpt.AsyncCheckpointer()
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state, start = ckpt.restore_checkpoint(args.ckpt_dir, state)
        print(f"[train] resumed from step {start}")

    data = iter(LmBatches(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                          device=str(dev)))
    t0 = time.time()
    tokens_done = 0
    losses = []
    for step in range(start, args.steps):
        state, metrics = step_fn(state, next(data))
        losses.append(metrics["loss"])
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0:
            tps = tokens_done / (time.time() - t0)
            print(f"[train] step={step + 1} loss={float(metrics['loss']):.4f}"
                  f" lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} tok/s={tps:.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpointer.save(args.ckpt_dir, step + 1, state)
            ckpt.prune_old(args.ckpt_dir, keep=3)
    checkpointer.wait()
    if args.ckpt_dir:
        ckpt.save_checkpoint(args.ckpt_dir, args.steps, state)
    print("[train] done")
    return [float(x) for x in losses]


def train_config(arch: str, lr: float, steps: int):
    """The optimizer config the launcher trains ``arch`` with: WSD for
    minicpm (its paper's schedule), cosine otherwise; warmup
    max(steps // 20, 5)."""
    from repro_torch.launch.cells import lm_schedule
    from repro_torch.training import optimizer as opt_mod

    return opt_mod.AdamWConfig(
        lr=lr, total_steps=steps, warmup_steps=max(steps // 20, 5),
        schedule=lm_schedule(arch))


if __name__ == "__main__":
    main()
