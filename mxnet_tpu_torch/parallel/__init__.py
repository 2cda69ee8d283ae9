"""Data-parallel training over ``torch.distributed`` (counterpart of
``mxnet_tpu/parallel``): the runtime (``distributed``), named meshes of
ranks (``mesh``), the data-parallel train step (``data_parallel``) and
the resumable loops (``resilience``). The JAX package's ``get_shard_map``
has no counterpart: each rank runs its own program. Tensor, sequence,
pipeline and expert parallelism are the model-parallel half of
ROADMAP.md A.12."""
from .mesh import (make_mesh, use_mesh, current_mesh, shard_array,  # noqa: F401
                   P, PartitionSpec, Mesh, AXES)
from .data_parallel import (build_train_step, tree_optimizer_step,  # noqa: F401
                            replicate_params, shard_batch, block_loss_fn,
                            weight_update_spec)
from .resilience import (Heartbeat, ResumableLoop,  # noqa: F401
                         SimulatedFailure, run_resilient)
from . import distributed  # noqa: F401
from .distributed import init_process_group, global_mesh  # noqa: F401
