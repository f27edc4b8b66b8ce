"""Parallelism over `torch.distributed`: device meshes (`mesh.py`), the
sharding-rule engine (`sharding.py`), collectives over a mesh axis
(`xla_ops.py`), the GPipe schedule over a `pp` axis (`pipeline.py`),
process-group bring-up (`distributed.py`) and collective groups
(`collective.py`)."""

from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, auto_mesh, hybrid_mesh, local_cpu_mesh,
                                         make_mesh)
from ray_tpu_torch.parallel.sharding import (ShardingRules, batch_spec, data_sharding,
                                             llama_rules, shard_tree, tree_paths)
from ray_tpu_torch.parallel.distributed import (barrier, initialize_multihost, is_multihost,
                                                process_count, process_index)
from ray_tpu_torch.parallel.pipeline import (make_microbatches, pipeline_apply,
                                              shard_pipeline_params, stack_stage_params)
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel import xla_ops

__all__ = [
    "AXIS_ORDER", "make_mesh", "auto_mesh", "hybrid_mesh", "local_cpu_mesh",
    "ShardingRules", "llama_rules", "batch_spec", "data_sharding", "shard_tree",
    "tree_paths", "collective", "xla_ops", "pipeline_apply", "make_microbatches",
    "stack_stage_params", "shard_pipeline_params", "initialize_multihost", "is_multihost",
    "process_index", "process_count", "barrier",
]
