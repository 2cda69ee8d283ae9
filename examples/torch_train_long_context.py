#!/usr/bin/env python
"""Long-context causal-LM training with sequence parallelism on the
PyTorch port (the twin of ``examples/train_long_context.py``).

A transformer whose attention runs SHARDED OVER THE SEQUENCE on the 'sp'
mesh axis: every rank of the group holds its block of T/n positions. Two
interchangeable strategies (pick with --sp-strategy):

  ring     parallel.ring_attention — K/V blocks rotate around the group
           (point-to-point sends), n steps, O(T/n · T/n) score memory, no
           head-count constraint; each block takes the flash kernels under
           the attention seam's rule (bf16, head dim 64 or 128, T >= 256)
  ulysses  parallel.ulysses_attention — two all_to_alls re-lay sequence
           blocks as head groups, exact attention per head group; fewer
           exchanges, needs heads % sp == 0

Everything else (embeddings, MLPs, loss) runs on the rank's block; the
gradients are averaged over the group and Adam updates every rank's copy
(``parallel.build_train_step`` with the batch split over ``sp``).

One process (a group of one, on the card):
    python examples/torch_train_long_context.py --dtype bfloat16
Several (gloo on the CPU, or NCCL with a card a rank):
    python tools/torch_launch.py -n 2 python \\
        examples/torch_train_long_context.py --device cpu --sp-strategy ulysses
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as tF  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import parallel  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.parallel import distributed  # noqa: E402


def init_params(gen, vocab, d, heads, layers, scale=0.02, device="cpu"):
    """The JAX example's parameter tree, drawn from ``gen`` (a seeded
    ``torch.Generator`` on the CPU), on ``device``."""
    def normal(*shape):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    p = {"embed": normal(vocab, d), "unembed": normal(d, vocab),
         "layers": []}
    for _ in range(layers):
        p["layers"].append({"qkv": normal(d, 3 * d), "proj": normal(d, d),
                            "up": normal(d, 4 * d), "down": normal(4 * d, d)})
    return p


def _norm(x):
    h = x - x.mean(-1, keepdim=True)
    return h / torch.sqrt((h * h).mean(-1, keepdim=True) + 1e-5)


def build_forward(mesh, heads, attn_fn, dtype=torch.float32):
    def fwd(params, tok):
        # tok (B, T/n): this rank's block; the embedding lookup is local
        x = params["embed"][tok].to(dtype)                # (B, T, D)
        B, T, D = x.shape
        hd = D // heads
        for lp in params["layers"]:
            h = _norm(x)
            qkv = h @ lp["qkv"].to(dtype)                 # (B, T, 3D)
            q, k, v = qkv.split(D, dim=-1)

            def heads_first(t):
                return t.reshape(B, T, heads, hd).transpose(1, 2) \
                    .contiguous()
            a = attn_fn(heads_first(q), heads_first(k), heads_first(v),
                        mesh, causal=True)                # (B, H, T, hd)
            a = a.transpose(1, 2).reshape(B, T, D)
            x = x + a @ lp["proj"].to(dtype)
            h = _norm(x)
            x = x + tF.gelu(h @ lp["up"].to(dtype),
                            approximate="tanh") @ lp["down"].to(dtype)
        return x @ params["unembed"].to(dtype)            # (B, T, V)
    return fwd


def width(n, heads=None, d=None):
    """(heads, d): the JAX example's, scaled with the group so heads == sp
    divides d and the Ulysses head requirement for any group size."""
    heads = heads or n
    if d is None:
        d = max(128, 16 * heads)
        d += (-d) % heads
    return heads, d


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp-strategy", choices=["ring", "ulysses"],
                    default="ring")
    ap.add_argument("--seq", type=int, default=0,
                    help="context length (default 256 per sp rank)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--heads", type=int, default=0,
                    help="default: the group's size, as the JAX example")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: cuda:<rank % cards>, NCCL) or cpu "
                         "(gloo)")
    return ap.parse_args(argv)


def main(argv=None, params=None):
    """Joins the process group (``distributed.init_process_group``: the
    launcher's environment, or a group of one) unless one is up, and
    returns {"losses", "T", "d", "heads", "world", "tok_per_s"};
    ``params`` (the JAX example's tree as numpy) replace the initial
    parameters."""
    args = parse(argv)
    if not distributed.is_initialized():
        distributed.init_process_group(
            device="cpu" if args.device == "cpu" else None)
    dev = distributed.device()
    if dev is None or dev.type != ("cpu" if args.device == "cpu" else "cuda"):
        raise RuntimeError("the process group runs on %s, not %s"
                           % (dev, args.device))
    resolve_device(dev)
    n = distributed.size()
    mesh = parallel.make_mesh({"sp": n})
    heads, d = width(n, args.heads or None, args.width or None)
    vocab, layers = 512, 2
    T = args.seq or 256 * n
    B = 2
    dtype = getattr(torch, args.dtype)
    print("mesh sp=%d  context T=%d  strategy=%s  heads=%d  d=%d  %s"
          % (n, T, args.sp_strategy, heads, d, args.dtype))

    attn = (parallel.ring_attention if args.sp_strategy == "ring"
            else parallel.ulysses_attention)
    fwd = build_forward(mesh, heads, attn, dtype)
    gen = torch.Generator().manual_seed(0)
    if params is None:
        params = init_params(gen, vocab, d, heads, layers, device=dev)
    else:
        params = {"embed": torch.tensor(np.asarray(params["embed"]),
                                        device=dev),
                  "unembed": torch.tensor(np.asarray(params["unembed"]),
                                          device=dev),
                  "layers": [{k: torch.tensor(np.asarray(v), device=dev)
                              for k, v in lp.items()}
                             for lp in params["layers"]]}
    opt = mx.optimizer.Adam(learning_rate=3e-4)
    init_states, _ = parallel.tree_optimizer_step(opt)
    states = init_states(params)

    def loss_fn(p, batch, key):
        tok, target = batch
        logits = fwd(p, tok).float()
        lp = torch.log_softmax(logits, -1)
        return -lp.gather(-1, target[..., None]).mean()

    step = parallel.build_train_step(loss_fn, opt, mesh=mesh,
                                     batch_spec="sp")
    rng = np.random.default_rng(0)
    data = rng.integers(0, vocab, (B, T + 1))
    tok = parallel.shard_array(torch.tensor(data[:, :-1], device=dev), mesh,
                               None, "sp")
    tgt = parallel.shard_array(torch.tensor(data[:, 1:], device=dev), mesh,
                               None, "sp")

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        params, states, loss = step(params, states, i + 1, None, (tok, tgt))
        losses.append(float(loss))
    dt = time.perf_counter() - t0
    print("%d steps, final loss %.4f, %.1f tok/s"
          % (args.steps, losses[-1], args.steps * B * T / dt))
    assert math.isfinite(losses[-1])
    return {"losses": losses, "T": T, "d": d, "heads": heads, "world": n,
            "tok_per_s": args.steps * B * T / dt}


if __name__ == "__main__":
    main()
