"""mxnet_tpu_torch.ir — one typed graph IR and pass pipeline under the
port's captures (counterpart of ``mxnet_tpu/ir``).

The bulk window's deferred chain, a ``Symbol`` graph (``Symbol.eval``,
the ``Executor``'s inference forward, ``SymbolBlock``) and the tape's
compiled backward convert into the same canonical typed
:class:`~mxnet_tpu_torch.ir.graph.Graph`, whose content-addressed key is
the one program-cache key; the forward captures run the same exact pass
pipeline (CSE, constant folding, cast sinking, dead-node elimination:
:mod:`~mxnet_tpu_torch.ir.passes`) and lower to ONE program per canonical
graph (:mod:`~mxnet_tpu_torch.ir.lower`): a CUDA graph on the card, the
op-by-op runner on the CPU. The same math from two captures shares one
program. :mod:`~mxnet_tpu_torch.ir.tune` searches the pass configs, the
serving buckets, the bulk watermark and the fp32 flash split.
"""
from . import graph, lower, passes, tune  # noqa: F401
from .graph import (Graph, GraphBuilder, Node, UnsupportedGraph,  # noqa: F401
                    build_runner, canonical_key, canonicalize, from_fx,
                    from_symbol, from_window, symbol_skeleton, to_fx)
from .lower import lower_forward, prepare, stats, tape_program  # noqa: F401
from .passes import DEFAULT_PASSES, PassManager, pass_stats  # noqa: F401

__all__ = ["Graph", "GraphBuilder", "Node", "UnsupportedGraph",
           "build_runner", "canonical_key", "canonicalize", "from_symbol",
           "from_window", "from_fx", "to_fx", "symbol_skeleton",
           "lower_forward", "prepare", "tape_program", "stats",
           "PassManager", "DEFAULT_PASSES", "pass_stats", "graph", "passes",
           "lower", "tune"]
