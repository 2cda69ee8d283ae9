"""Monitor: statistics of blocks' outputs during training (counterpart of
``mxnet_tpu/monitor.py``; ref: python/mxnet/monitor.py).

Forward hooks on a Gluon block tree. A hybridized block runs its children
inside its program (a CUDA graph replay on the card, where they are not
called at all), so, as in the JAX package, only the hybridized block's
own output is seen; an eager tree gives every block's. A hook called
inside a hybridized program (``gluon.hybrid.inside_program``, the CPU's
eager run of a program) is skipped, so the entries are the same on the
card and on the CPU.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .ndarray import NDArray

__all__ = ["Monitor"]


def _stat_norm(x):
    a = np.asarray(x)
    return float(np.sqrt((a.astype(np.float64) ** 2).mean()))


def _host(o):
    if isinstance(o, torch.Tensor):
        o = NDArray(o)
    return o.asnumpy()


class Monitor:
    def __init__(self, interval=1, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _stat_norm
        self.pattern = re.compile(pattern)
        self.queue = []
        self.step = 0
        self.activated = False
        self._hooks = []

    def install(self, block):
        """Register a forward hook on every block of ``block``'s tree."""
        from .gluon.hybrid import inside_program

        def hook(blk, inputs, output):
            if not self.activated or inside_program():
                return
            name = blk.name
            if self.pattern.match(name):
                outs = output if isinstance(output, (list, tuple)) \
                    else [output]
                for i, o in enumerate(outs):
                    if isinstance(o, (NDArray, torch.Tensor)):
                        self.queue.append((self.step, "%s_output%d" % (name, i),
                                           self.stat_func(_host(o))))

        def walk(b):
            self._hooks.append(b.register_forward_hook(hook))
            for c in b._children.values():
                walk(c)

        walk(block)
        return self

    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []

    def toc(self):
        self.activated = False
        self.step += 1
        res = list(self.queue)
        self.queue = []
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            print("Batch %d: %s = %.6f" % (step, name, stat))
