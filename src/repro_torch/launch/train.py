"""Training launcher: arch registry -> Model -> train step -> double-buffered
data pipeline -> checkpointing (resume, async, retention) -> metrics.

The port of ``repro/launch/train.py``, on one device, with the same flags
plus ``--device`` (the card unless ``--device cpu``). Parameters are drawn
on the device from a ``torch.Generator`` seeded with 0; a run resumes from
the newest checkpoint in ``--ckpt-dir``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-34b \
      --smoke --steps 100 --ckpt-dir /tmp/ckpt [--device cpu]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    """Train ``--steps`` steps (from the checkpoint's step, if any);
    returns the last step's metrics as floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-34b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="bigram", choices=["bigram", "random"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.core.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.training import data as data_mod
    from repro_torch.training import elastic as el
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts_mod

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    tcfg = ts_mod.TrainConfig(
        optimizer=opt_mod.OptimizerConfig(
            learning_rate=args.lr, warmup_steps=max(args.steps // 20, 5),
            total_steps=args.steps),
        microbatches=args.microbatches,
        grad_compression=args.compression)

    def init_state():
        model = Model(cfg, device=dev, remat=not args.smoke,
                      generator=torch.Generator(dev).manual_seed(0))
        return ts_mod.init_train_state(model)

    ecfg = el.ElasticConfig(ckpt_dir=args.ckpt_dir,
                            steps_between_checkpoints=args.ckpt_every)
    policy = el.CheckpointPolicy(ecfg)
    state, start_step = el.resume_or_init(ecfg, init_state)
    step_fn = ts_mod.make_train_step(state.model, tcfg)
    n_params = sum(p.numel() for p in state.params)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M start={start_step} "
          f"device={dev}", flush=True)

    batch_fn = (data_mod.bigram_batch if args.data == "bigram"
                else data_mod.synthetic_batch)
    loader = data_mod.PrefetchingLoader(
        batch_fn, args.batch, args.seq, cfg.vocab_size,
        start_step=start_step, device=dev)
    t0 = time.time()
    tokens_seen = 0
    metrics = {}
    try:
        for _ in range(start_step, args.steps):
            step_no, batch = next(loader)
            state, metrics = step_fn(state, batch)
            tokens_seen += args.batch * args.seq
            if (step_no + 1) % args.log_every == 0:
                dt = time.time() - t0
                print(f"step {step_no + 1:5d} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"tok/s={tokens_seen / dt:.0f}", flush=True)
            policy.maybe_save(step_no + 1, state)
    finally:
        loader.close()
    policy.finalize(args.steps, state)
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s", flush=True)
    return {k: float(v) for k, v in metrics.items()}


if __name__ == "__main__":
    main()
