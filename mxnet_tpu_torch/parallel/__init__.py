"""The port's counterpart of ``mxnet_tpu/parallel``: only
``tree_optimizer_step`` so far. Meshes, sharding and the compiled
distributed train steps are ROADMAP.md A.12."""
from .data_parallel import tree_optimizer_step  # noqa: F401
