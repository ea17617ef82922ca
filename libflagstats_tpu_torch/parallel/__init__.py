"""Data-parallel flagstat: several devices of one process
(parallel/sharded.py) and several processes over torch.distributed
(parallel/multihost.py)."""
from .sharded import data_devices, flagstat_sharded, shard_bounds  # noqa: F401
