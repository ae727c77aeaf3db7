"""Data parallelism on torch.distributed (counterpart of
`repro.distributed`): the plan, the fp8 wire and cross-replica amax sync."""
from repro_torch.distributed.amax_sync import (all_reduce_amax, host_amax_sync,
                                               make_amax_sync)
from repro_torch.distributed.strategy import (DataParallel, ParallelPlan,
                                              TensorParallel, ZeRO1Sharded)

__all__ = ["all_reduce_amax", "host_amax_sync", "make_amax_sync",
           "DataParallel", "ZeRO1Sharded", "TensorParallel", "ParallelPlan"]
