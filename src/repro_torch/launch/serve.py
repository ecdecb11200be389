"""Serving launcher: continuous-batching decode over any architecture.

The port of ``repro/launch/serve.py``, with the same flags plus
``--device`` (the card unless ``--device cpu``). Parameters are drawn on
the device from a ``torch.Generator`` seeded with 0.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-34b \
      --smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    """Serve ``--requests`` random prompts through a ``SlotBatcher``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-34b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.core.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.serving.batcher import Request, SlotBatcher

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    model = Model(cfg, device=dev,
                  generator=torch.Generator(dev).manual_seed(0))
    batcher = SlotBatcher(model, args.batch_size, args.max_len)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        plen = int(rng.integers(4, 12))
        batcher.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=args.max_new))
    done = batcher.run(steps=args.requests * (args.max_new + 4))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = sum(len(v) for v in done.values())
    print(f"served {len(done)}/{args.requests} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s, "
          f"{args.batch_size} slots, {dev})")
    for rid in sorted(done)[:3]:
        print(f"  req {rid}: {done[rid][:20].tolist()}")
    return done


if __name__ == "__main__":
    main()
