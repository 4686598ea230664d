"""repro_torch.distributed — the sharding resolver, gradient compression
and the elastic helpers."""
from .compression import (compress_int8, compress_topk,
                          compressed_tree_allreduce, decompress_int8,
                          init_error)
from .elastic import ElasticRunner, StepWatchdog, viable_meshes
from .sharding import (DEFAULT_RULES, Mesh, ShardingCtx, TensorSpec,
                       current_ctx, resolve_spec, use_mesh)

__all__ = ["compress_int8", "compress_topk", "compressed_tree_allreduce",
           "decompress_int8", "init_error", "ElasticRunner", "StepWatchdog",
           "viable_meshes", "DEFAULT_RULES", "Mesh", "ShardingCtx",
           "TensorSpec", "current_ctx", "resolve_spec", "use_mesh"]
