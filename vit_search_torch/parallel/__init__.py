"""Multi-process runs over ``torch.distributed`` (see ``parallel.mesh``)."""

from .mesh import (all_gather, all_reduce_mean_, all_reduce_sum, any_process, backend_for,
                   barrier, batch_slice, describe, init_distributed, is_main_process,
                   local_rank, process_count, process_device, process_index, replicate,
                   shutdown, sum_over_processes)

__all__ = [
    "all_gather", "all_reduce_mean_", "all_reduce_sum", "any_process", "backend_for",
    "barrier", "batch_slice", "describe", "init_distributed", "is_main_process",
    "local_rank", "process_count", "process_device", "process_index", "replicate",
    "shutdown", "sum_over_processes",
]
