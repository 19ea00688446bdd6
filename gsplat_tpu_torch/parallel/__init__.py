"""The multi-device modes on `torch.distributed`, one process per shard
(port of `gsplat_tpu.parallel`): the tile-sharded render and train step
(`sharding.py`, `train_step.py`), the Gaussian-sharded render and training
(`gaussian_sharded.py`, `gaussian_train.py`), and process-group set-up and
a launcher (`multihost.py`)."""
