"""repro_torch.distributed — gradient compression and elastic helpers."""
from .compression import (compress_int8, compress_topk,
                          compressed_tree_allreduce, decompress_int8,
                          init_error)
from .elastic import StepWatchdog, viable_meshes

__all__ = ["compress_int8", "compress_topk", "compressed_tree_allreduce",
           "decompress_int8", "init_error", "StepWatchdog", "viable_meshes"]
