"""Failure recovery: resume from the newest checkpoint, or start afresh.

The port of ``repro/training/elastic.py``. The contract:

  1. after a failure the job restarts (possibly with another world size or
     mesh shape) and calls :func:`resume_or_init`, which restores the
     newest intact checkpoint *onto the current mesh* (checkpoints hold
     unsharded leaves, so any mesh works: an elastic rescale is a
     re-placement), or builds the step-0 state when there is none;
  2. the data pipeline is deterministic per step, so training replays
     exactly from the restored step (held bitwise by
     ``tests/test_torch_checkpoint.py`` and ``chip_smoke.py``);
  3. :class:`CheckpointPolicy` saves every ``steps_between_checkpoints``
     steps (in the background by default) and once more at the end.

Where the JAX package builds only the state's shapes (``jax.eval_shape``),
the port builds the step-0 state, places it under ``shardings`` and
restores into it in place (each rank reading its own blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training import sharding


@dataclasses.dataclass
class ElasticConfig:
    """Where checkpoints go, how often, how many are kept, and whether
    they are written in the background."""

    ckpt_dir: str = "checkpoints"
    steps_between_checkpoints: int = 50
    keep: int = 3
    async_save: bool = True


def resume_or_init(ecfg: ElasticConfig, init_fn: Callable[[], Any],
                   shardings: Optional[Any] = None):
    """Returns (state, start_step). ``init_fn`` builds the step-0 state (a
    ``TrainState`` or a tree); it is placed under ``shardings`` (a state:
    ``(param_shardings, opt_state_shardings)``; a tree: a matching tree
    of ``NamedSharding``) when given, and with a checkpoint in
    ``ecfg.ckpt_dir`` the newest one is restored into it."""
    from repro_torch.training.train_step import TrainState

    step = ckpt_mod.latest_step(ecfg.ckpt_dir)
    state = init_fn()
    if step is not None:
        return ckpt_mod.restore(ecfg.ckpt_dir, step, state, shardings), step
    if shardings is None:
        return state, 0
    if isinstance(state, TrainState):
        return sharding.distribute_train_state(state, shardings), 0
    return ckpt_mod.place_tree(state, shardings), 0


class CheckpointPolicy:
    """Drives periodic (optionally async) checkpointing from the train loop."""

    def __init__(self, ecfg: ElasticConfig):
        self.ecfg = ecfg
        self.saver = ckpt_mod.AsyncSaver() if ecfg.async_save else None

    def maybe_save(self, step: int, state) -> bool:
        """Save ``state`` if ``step`` is a multiple of the cadence."""
        if step % self.ecfg.steps_between_checkpoints:
            return False
        if self.saver is not None:
            self.saver.save(self.ecfg.ckpt_dir, step, state,
                            keep=self.ecfg.keep)
        else:
            ckpt_mod.save(self.ecfg.ckpt_dir, step, state,
                          keep=self.ecfg.keep)
        return True

    def finalize(self, step: int, state):
        """Join a write in flight, then save ``state`` at ``step``."""
        if self.saver is not None:
            self.saver.wait()
        ckpt_mod.save(self.ecfg.ckpt_dir, step, state, keep=self.ecfg.keep)
