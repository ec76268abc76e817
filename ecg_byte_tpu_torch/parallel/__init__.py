"""Data parallelism (``--dis``): process groups, the rows of a rank and the
collectives that make a rank's step the single-process step on the global
batch (``parallel/distributed.py``); the global batches as steps every
rank agrees on (``parallel/batches.py``); local ranks as spawned processes
(``parallel/spawn.py``).  Tensor parallelism and ZeRO-3 (``--tp``,
``--fsdp``): the (dp, fsdp, tp) grid of the ranks and its groups
(``parallel/mesh.py``) and a rank's shards of the parameters, the
adapters and Adam's moments (``parallel/sharding.py``)."""

from ecg_byte_tpu_torch.parallel.distributed import Rows

__all__ = ["Rows"]
