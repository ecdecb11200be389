"""Training on one device or over a mesh: the port of the JAX package's
``training``.

``optimizer`` (AdamW, schedule, clipping, op for op as JAX computes them),
``train_step`` (``TrainState`` with float32 masters of the bfloat16
leaves, the loss, microbatches summed in float32, ``make_train_step``),
``compression`` (bf16 / int8 round trips with error feedback), ``data``
(the token streams, ``memmap_batch_fn``, ``PrefetchingLoader``),
``checkpoint`` (atomic saves in the JAX package's layout, so either
package restores the other's), ``elastic`` (resume or init, periodic
saves) and ``sharding`` (the placement policy over a ``DeviceMesh``: the
same train step on a placed state).
"""

from repro_torch.training import checkpoint, elastic
from repro_torch.training.optimizer import (OptimizerConfig, OptState,
                                            init_opt_state)
from repro_torch.training.train_step import (TrainConfig, TrainState,
                                             init_train_state,
                                             make_train_step)

__all__ = ["OptimizerConfig", "OptState", "init_opt_state", "TrainConfig",
           "TrainState", "init_train_state", "make_train_step",
           "checkpoint", "elastic"]
