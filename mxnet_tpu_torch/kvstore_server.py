"""``mx.kvstore_server`` (counterpart of ``mxnet_tpu/kvstore_server.py``;
ref: python/mxnet/kvstore_server.py).

Not applicable, as in the JAX package: upstream's distributed training
runs parameter-server processes (ps-lite's scheduler, server and worker
roles). The port has no server role: every rank is a worker of one
``torch.distributed`` group, and the gradients reduce through NCCL (on
cards) or gloo (on the CPU) collectives (``kvstore``'s ``dist_*`` stores,
``dist``, ``parallel``). This module exists so a role-launching script
fails with that reason instead of an ImportError."""
from __future__ import annotations

__all__ = ["KVStoreServer"]

_RATIONALE = (
    "the PyTorch port has no parameter-server role: every process is a "
    "worker of one torch.distributed group, and gradients reduce through "
    "NCCL or gloo collectives (kvstore.create('dist_sync'), "
    "mxnet_tpu_torch.dist, mxnet_tpu_torch.parallel). Launch every "
    "process as a worker (tools/launch.py).")


class KVStoreServer:
    """(ref: kvstore_server.py:KVStoreServer) Not applicable here."""

    def __init__(self, kvstore=None):
        raise RuntimeError(_RATIONALE)


def _init_kvstore_server_module():
    """Upstream calls this when DMLC_ROLE=server; here it says why there is
    no such role."""
    raise RuntimeError(_RATIONALE)
