"""Train a ~100M-parameter LM with the PyTorch port's training substrate:
AdamW + schedule, per-layer remat, optional int8 gradient compression,
async checkpoints and a resume drill; on the card by default.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
        [--device cpu] [--compress-grads]

A checkpoint is written every 100 steps and at the last step; the drill
restores the latest and checks it equals the state it was taken from,
bit for bit.
"""
import argparse
import shutil
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_step as ts_mod
from repro_torch.training.data import LmBatches

CKPT_EVERY = 100


def _equal(a, b) -> bool:
    fa, fb = list(opt_mod.flatten(a)), list(opt_mod.flatten(b))
    return len(fa) == len(fb) and all(
        pa == pb and torch.equal(x, y) for (pa, x), (pb, y) in zip(fa, fb))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params: 12L x d512 (GQA 8/4 heads), 32k vocab.
    cfg = tfm.TransformerConfig(
        name="lm-100m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
        d_head=64, d_ff=2048, vocab=32768, dtype=torch.float32,
        attn_chunk_q=64, attn_chunk_k=64)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_lm(cfg, gen, device=dev, dtype=torch.float32)
    print(f"[train] {cfg.name}: {cfg.n_params() / 1e6:.0f}M params on {dev}")

    opt_cfg = opt_mod.AdamWConfig(lr=6e-4, warmup_steps=20,
                                  total_steps=args.steps, schedule="cosine")
    step_fn = ts_mod.make_train_step(
        lambda p, b: tfm.lm_loss(cfg, p, b), opt_cfg,
        compress_grads=args.compress_grads)
    state = ts_mod.init_train_state(params,
                                    compress_grads=args.compress_grads)

    data = iter(LmBatches(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                          device=str(dev)))
    ckpt_dir = tempfile.mkdtemp(prefix="lm100m_ckpt_")
    checkpointer = ckpt.AsyncCheckpointer()
    try:
        t0 = time.time()
        first_loss = None
        for step in range(args.steps):
            state, metrics = step_fn(state, next(data))
            if first_loss is None:
                first_loss = float(metrics["loss"])
            if (step + 1) % 20 == 0:
                tok_s = args.batch * args.seq * (step + 1) / (time.time()
                                                              - t0)
                print(f"[train] step {step + 1}: "
                      f"loss={float(metrics['loss']):.4f} "
                      f"lr={float(metrics['lr']):.2e} tok/s={tok_s:.0f}")
            if (step + 1) % CKPT_EVERY == 0 or step + 1 == args.steps:
                checkpointer.save(ckpt_dir, step + 1, state)
        final = float(metrics["loss"])
        secs = time.time() - t0
        checkpointer.wait()
        print(f"[train] loss {first_loss:.3f} -> {final:.3f} "
              f"({'improved' if final < first_loss else 'NOT improved'})")

        # Crash-and-resume drill: the latest checkpoint is the state now.
        restored, at = ckpt.restore_checkpoint(ckpt_dir, state)
        same = _equal(restored, state)
        print(f"[train] resume drill: restored step {at} checkpoint "
              f"{'equal to the saved state bit for bit' if same else 'DIFFERS'}")
    finally:
        checkpointer.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"first_loss": first_loss, "final_loss": final,
            "improved": final < first_loss, "restored_step": at,
            "restored_equal": same,
            "tokens_per_s": args.batch * args.seq * args.steps / secs}


if __name__ == "__main__":
    main()
