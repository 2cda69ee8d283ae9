#!/usr/bin/env python
"""BERT pretraining with the distributed train step on a dp × tp mesh, on
the PyTorch port (the twin of ``examples/train_bert_distributed.py``).

The step (forward, backward, the gradients averaged over 'dp', Adam) is
``parallel.build_train_step``; the parameters are split over 'tp' by the
TRANSFORMER_RULES name-pattern specs (``tensor_parallel.spec_for``), and
inside the step ``tp_scope`` runs the Megatron split of every layer that
reads a split leaf (the attention's heads, the FFN's columns and rows,
the MLM decoder's vocabulary) with the collectives on the 'tp' group.

One process (a group of one):
    python examples/torch_train_bert_distributed.py --device cpu
Several (gloo on the CPU, or NCCL with a card a rank):
    python tools/torch_launch.py -n 2 python \\
        examples/torch_train_bert_distributed.py --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import gluon, parallel  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.models.bert import BERTModel  # noqa: E402
from mxnet_tpu_torch.parallel import distributed  # noqa: E402
from mxnet_tpu_torch.parallel.tensor_parallel import (  # noqa: E402
    TRANSFORMER_RULES, shard_params, spec_for)

BERT = dict(vocab_size=1024, units=128, hidden_size=512, num_layers=2,
            num_heads=4, max_length=64)


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: cuda:<rank % cards>, NCCL) or cpu "
                         "(gloo)")
    return ap.parse_args(argv)


def main(argv=None, weights=None):
    """Joins the process group (the launcher's environment, or a group of
    one) unless one is up; returns {"losses", "mesh", "specs",
    "seconds"}. ``weights`` ({name: array}) replace the initial
    parameters (``convert.carry_params``)."""
    args = parse(argv)
    if not distributed.is_initialized():
        distributed.init_process_group(
            device="cpu" if args.device == "cpu" else None)
    dev = distributed.device()
    resolve_device(dev)
    n = distributed.size()
    tp = 2 if n % 2 == 0 else 1
    mesh = parallel.make_mesh({"dp": -1, "tp": tp})
    print("mesh:", dict(mesh.shape))

    with mx.Context(dev.type, dev.index or 0):
        mx.random.seed(0)
        bert = BERTModel(dropout=args.dropout, **BERT)
        bert.initialize()
        if weights is not None:
            from mxnet_tpu_torch.convert import carry_params

            carry_params(bert, weights)
    loss_fn, plist = parallel.block_loss_fn(
        bert, gluon.loss.SoftmaxCrossEntropyLoss(), training=True,
        out_index=-1)
    named = [(p.name, p._tensor().detach()) for p in plist]
    specs = [spec_for(name, tuple(a.shape), TRANSFORMER_RULES, mesh)
             for name, a in named]
    params = shard_params(named, mesh)

    opt = mx.optimizer.Adam(learning_rate=1e-3)
    init_states, _ = parallel.tree_optimizer_step(opt)
    states = init_states(params)
    step = parallel.build_train_step(loss_fn, opt, mesh=mesh,
                                     param_spec=specs)

    rng = np.random.default_rng(0)
    B = 4 * mesh.shape["dp"]
    V, T = BERT["vocab_size"], BERT["max_length"]
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        tok = rng.integers(0, V, (B, T))
        mp = rng.integers(0, T, (B, 8))
        mlm_y = rng.integers(0, V, (B, 8))
        # no token types and no valid length, as the JAX example's call
        tok_b, mp_b, y_b = parallel.shard_batch(
            (torch.tensor(tok, dtype=torch.int32, device=dev),
             torch.tensor(mp, dtype=torch.int32, device=dev),
             torch.tensor(mlm_y, dtype=torch.float32, device=dev)), mesh)
        params, states, loss = step(params, states, i + 1, None,
                                    (tok_b, None, None, mp_b, y_b))
        losses.append(float(loss))
        print("step %d loss %.4f" % (i, losses[-1]))
    return {"losses": losses, "mesh": dict(mesh.shape),
            "specs": [str(tuple(s)) for s in specs],
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
