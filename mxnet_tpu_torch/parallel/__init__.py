"""Distributed training over ``torch.distributed`` (counterpart of
``mxnet_tpu/parallel``): the runtime (``distributed``), named meshes of
ranks (``mesh``), the data-parallel train step (``data_parallel``, which
also keeps tensor-parallel and fully sharded parameters as blocks),
tensor parallelism (``tensor_parallel``), ring and Ulysses sequence
parallelism (``ring_attention``, ``ulysses``, and the attention seam's
``sequence_parallel_scope``), pipelines (``pipeline``), experts
(``expert_parallel``) and the resumable loops (``resilience``). The JAX
package's ``get_shard_map`` has no counterpart: each rank runs its own
program."""
from .mesh import (make_mesh, named_sharding, replicated,  # noqa: F401
                   use_mesh, current_mesh, shard_array, P, PartitionSpec,
                   NamedSharding, Mesh, AXES)
from .data_parallel import (build_train_step, tree_optimizer_step,  # noqa: F401
                            replicate_params, shard_batch, block_loss_fn,
                            weight_update_spec)
from . import tensor_parallel  # noqa: F401
from .tensor_parallel import (shard_params, param_specs, constrain,  # noqa: F401
                              psum_region_entry, psum_region_exit)
from .ring_attention import ring_attention, full_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
from .pipeline import (pipeline_apply, pipeline_apply_interleaved,  # noqa: F401
                       pipeline_train_step_1f1b, stack_stage_params,
                       interleave_stage_params)
from .expert_parallel import moe_ffn  # noqa: F401
from ..ops.attention import sequence_parallel_scope  # noqa: F401
from .resilience import (Heartbeat, ResumableLoop,  # noqa: F401
                         SimulatedFailure, run_resilient)
from . import distributed  # noqa: F401
from .distributed import init_process_group, global_mesh  # noqa: F401
