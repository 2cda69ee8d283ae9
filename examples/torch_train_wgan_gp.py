"""WGAN-GP on synthetic 2-D data on the PyTorch port (the twin of
``examples/train_wgan_gp.py``): higher-order autograd in anger.

The gradient penalty needs d/dθ of ||d D(x̂)/d x̂|| — a grad THROUGH a grad.
``autograd.grad(..., create_graph=True)`` records the inner gradient
as a differentiable graph (ref: python/mxnet/autograd.py:grad), so the
outer ``loss.backward()`` reaches the discriminator weights through it.
The nets are Dense and tanh/relu only: no kernel's backward is
differentiated twice (a kernel's backward raises ``SecondOrderError``
under ``create_graph`` on a card).

    python examples/torch_train_wgan_gp.py [--steps 60] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon, nd  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402


def make_nets():
    G = gluon.nn.HybridSequential(prefix="gen_")
    with G.name_scope():
        G.add(gluon.nn.Dense(32, activation="relu"),
              gluon.nn.Dense(32, activation="relu"),
              gluon.nn.Dense(2))
    D = gluon.nn.HybridSequential(prefix="disc_")
    with D.name_scope():
        D.add(gluon.nn.Dense(32, activation="tanh"),
              gluon.nn.Dense(32, activation="tanh"),
              gluon.nn.Dense(1))
    G.initialize()
    D.initialize()
    return G, D


def real_batch(rng, n):
    """Two-moons-ish target distribution."""
    t = rng.uniform(0, np.pi, n)
    c = rng.integers(0, 2, n)
    x = np.stack([np.cos(t) + c - 0.5, np.sin(t) * (1 - 2 * c) + 0.25 * c],
                 axis=1)
    return (x + 0.05 * rng.normal(size=(n, 2))).astype(np.float32)


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--gp", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, weights=None):
    """Returns {"d_losses", "g_losses", "penalties", "seconds"};
    ``weights`` ({"gen": {...}, "disc": {...}}) replace the initial
    parameters (``convert.carry_params``)."""
    args = parse(argv)
    with context_from_device(resolve_device(args.device)):
        rng = np.random.default_rng(0)
        mx.random.seed(0)
        G, D = make_nets()
        if weights is not None:
            from mxnet_tpu_torch.convert import carry_params

            G(nd.zeros((1, 8)))  # the deferred shapes first
            D(nd.zeros((1, 2)))
            carry_params(G, weights["gen"])
            carry_params(D, weights["disc"])
        trainer_d = gluon.Trainer(D.collect_params(), "adam",
                                  {"learning_rate": 2e-3, "beta1": 0.5})
        trainer_g = gluon.Trainer(G.collect_params(), "adam",
                                  {"learning_rate": 2e-3, "beta1": 0.5})

        n = args.batch
        out = {"d_losses": [], "g_losses": [], "penalties": []}
        t0 = time.perf_counter()
        for step in range(args.steps):
            real = nd.array(real_batch(rng, n))
            noise = nd.array(rng.normal(size=(n, 8)).astype(np.float32))
            eps = nd.array(rng.uniform(size=(n, 1)).astype(np.float32))

            # ---- critic step with gradient penalty ----
            with autograd.record():
                fake = G(noise).detach()
                interp = eps * real + (1.0 - eps) * fake
                (gp,) = autograd.grad(D(interp).sum(), [interp],
                                      create_graph=True)
                gnorm = nd.sqrt((gp * gp).sum(axis=1) + 1e-12)
                penalty = ((gnorm - 1.0) ** 2).mean()
                d_loss = D(fake).mean() - D(real).mean() + args.gp * penalty
            d_loss.backward()
            trainer_d.step(n)

            # ---- generator step ----
            with autograd.record():
                g_loss = -D(G(noise)).mean()
            g_loss.backward()
            trainer_g.step(n)

            out["d_losses"].append(float(d_loss.asscalar()))
            out["g_losses"].append(float(g_loss.asscalar()))
            out["penalties"].append(float(penalty.asscalar()))
            if step % 10 == 0 or step == args.steps - 1:
                print("step %3d  d_loss %+.4f  g_loss %+.4f  penalty %.4f"
                      % (step, out["d_losses"][-1], out["g_losses"][-1],
                         out["penalties"][-1]))

        assert np.isfinite(out["d_losses"][-1])
        print("done — gradient-penalty training ran end to end")
    out["seconds"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    main()
