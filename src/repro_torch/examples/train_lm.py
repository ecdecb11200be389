"""End-to-end LM training: a granite-family model trained for a few
hundred steps on learnable synthetic data, with checkpointing and resume.

The port of ``examples/train_lm.py``, with the same configs (``lm-22m`` by
default, ``--full-100m`` for the 100M one) and flags, plus ``--device``
(the card unless ``--device cpu``). Parameters are drawn on the device
from a ``torch.Generator`` seeded with 0; a run resumes from the newest
checkpoint in ``--ckpt-dir`` (default: ``paris_train_lm`` in the system
temp dir).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import Model
from repro_torch.training import data as data_mod
from repro_torch.training import elastic as el
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_step as ts_mod


def model_config(full: bool) -> ModelConfig:
    """``lm-100m`` (``full``) or the CPU-sized ``lm-22m``."""
    if full:  # ~100M params
        return ModelConfig(
            name="lm-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=8192, mlp_type="swiglu")
    return ModelConfig(  # 12.6M params: a few minutes of CPU
        name="lm-22m", family="dense", num_layers=6, d_model=384,
        num_heads=6, num_kv_heads=2, head_dim=64, d_ff=1024,
        vocab_size=4096, mlp_type="swiglu")


def main(argv=None) -> dict:
    """Train, print the loss every 20 steps; returns the first and last
    losses, the steps run, the seconds and tokens/s."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "paris_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config(args.full_100m)
    tcfg = ts_mod.TrainConfig(optimizer=opt_mod.OptimizerConfig(
        learning_rate=1e-3, warmup_steps=20, total_steps=args.steps))
    ecfg = el.ElasticConfig(ckpt_dir=args.ckpt_dir,
                            steps_between_checkpoints=100)
    policy = el.CheckpointPolicy(ecfg)

    def init_state():
        model = Model(cfg, device=dev, remat=False,
                      generator=torch.Generator(dev).manual_seed(0))
        return ts_mod.init_train_state(model)

    state, start = el.resume_or_init(ecfg, init_state)
    step_fn = ts_mod.make_train_step(state.model, tcfg)
    n = sum(p.numel() for p in state.params)
    print(f"{cfg.name}: {n / 1e6:.1f}M params, resuming at step {start}, "
          f"on {dev}")

    loader = data_mod.PrefetchingLoader(
        data_mod.bigram_batch, args.batch, args.seq, cfg.vocab_size,
        start_step=start, device=dev)
    t0, toks = time.time(), 0
    first_loss, m = None, {}
    try:
        for _ in range(start, args.steps):
            step_no, batch = next(loader)
            state, m = step_fn(state, batch)
            toks += args.batch * args.seq
            if first_loss is None:
                first_loss = float(m["loss"])
            if (step_no + 1) % 20 == 0:
                print(f"step {step_no + 1:4d} loss={float(m['loss']):.4f} "
                      f"tok/s={toks / (time.time() - t0):.0f}", flush=True)
            policy.maybe_save(step_no + 1, state)
    finally:
        loader.close()
    policy.finalize(args.steps, state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    last = float(m["loss"]) if m else None
    if m:
        print(f"loss: {first_loss:.3f} -> {last:.3f} "
              f"({args.steps} steps, {dt:.0f}s)")
    return dict(first_loss=first_loss, last_loss=last,
                steps=args.steps - start, seconds=dt,
                tokens_per_s=toks / dt)


if __name__ == "__main__":
    main()
