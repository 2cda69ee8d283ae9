#!/usr/bin/env python3
"""GPT-2's gradients through ``torch.compile`` against eager on one card
(ROADMAP.md C.11, closed: ``base.cast_out``): a 2-layer GPT at GPT-2 small's widths (768 units, 12
heads, vocabulary 50257), batch 8 of 1024 tokens, dropout 0, in fp32 and in
bf16 via amp; the eager step and the step through
``torch.compile(backend="aot_eager", fullgraph=True)``, each in the
variants that locate a fault:

- ``record``: ``autograd.record()`` and the port's ``autograd.backward``
  (the parameter registry, ``torch.autograd.backward(inputs=...)``);
- ``plain``: ``loss.sum().backward()``, no registry;
- ``grad``: ``torch.autograd.grad`` of the parameter tensors;
- ``kernels_off`` and ``<kernel>_off``: ``record`` with every kernel op's
  implementation (or one kernel's) its plain version;
- ``functions``: small ``torch.autograd.Function``s alone, on the CPU and
  the card, whose forward returns a tensor an op made, an op's no-op
  ``.to()``/``.float()``, an in-place op's result, its input, a view of
  its input or of a made tensor; and the port's ``_Embedding`` and dense
  attention Functions: the relative L2 of each input's compiled gradient
  against eager's.

Prints, for each variant, every parameter whose compiled gradient parts
from eager's by more than 1e-2 (relative L2, then the two norms), and the
graph inputs Dynamo handed the backend: how many, how many require grad,
and how many are the same tensor twice.

    python3 tools/cuda_compile_grads.py [variant ...]
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VARIANTS = ("functions", "record", "plain", "grad", "kernels_off",
            "layernorm_off", "xent_off", "flash_off")
_OFF = {"kernels_off": None,
        "layernorm_off": ("fused_layernorm", "fused_layernorm_bwd"),
        "xent_off": ("softmax_xent_fwd", "softmax_xent_bwd"),
        "flash_off": ("flash_attention", "flash_attention_f32",
                      "flash_attention_bwd")}


def _plain_impls(names):
    """{IMPLS name: plain version} of ``names`` (every kernel for None)."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import layernorm as ln
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    plain = {"fused_layernorm": ln.layernorm_plain,
             "fused_layernorm_bwd": ln.layernorm_bwd_plain,
             "flash_attention": fa.flash_attention_plain,
             "flash_attention_f32": fa.flash_attention_plain,
             "flash_attention_bwd": fa.flash_attention_bwd_plain,
             "softmax_xent_fwd": sx.softmax_xent_fwd_plain,
             "softmax_xent_bwd": sx.softmax_xent_bwd_plain}
    return {k: v for k, v in plain.items() if names is None or k in names}


def _inputs_backend(log):
    """aot_eager, logging the graph inputs it is handed."""
    from torch._dynamo.backends.registry import lookup_backend

    def backend(gm, example_inputs):
        ts = [t for t in example_inputs if isinstance(t, torch.Tensor)]
        ids = [id(t) for t in ts]
        log.append({"inputs": len(ts),
                    "requires_grad": sum(t.requires_grad for t in ts),
                    "repeated": len(ids) - len(set(ids))})
        return lookup_backend("aot_eager")(gm, example_inputs)

    return backend


def _toy(forward):
    class Toy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return forward(x)

        @staticmethod
        def backward(ctx, g):
            return g * 2

    return Toy.apply


def _functions():
    """The ``functions`` variant: {case: [rel L2 per input]} per device."""
    from mxnet_tpu_torch.ops import attention, functional

    toys = {"made": _toy(lambda x: x * 2),
            "no-op to": _toy(lambda x: (x * 2).to(x.dtype)),
            "no-op float": _toy(lambda x: (x * 2).float()),
            "in place": _toy(lambda x: (x * 2).mul_(1.0)),
            "input": _toy(lambda x: x),
            "view of input": _toy(lambda x: x.view_as(x)),
            "view of made": _toy(lambda x: (x * 2).view_as(x))}
    out = {}
    for dev in ("cpu", "cuda"):
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(8, 16, device=dev, generator=gen)
        qkv = [torch.randn(1, 2, 64, 32, device=dev, generator=gen)
               for _ in range(3)]
        ids = torch.randint(0, 50, (64,), device=dev, generator=gen)
        table = torch.randn(50, 16, device=dev, generator=gen)
        cases = {k: (lambda t, f=f: f(t) * 1, [x]) for k, f in toys.items()}
        cases["port _Embedding"] = (
            lambda w: functional._Embedding.apply(ids, w), [table])
        cases["port dense attention fp32"] = (
            lambda q, k, v: attention.dense_attention(q, k, v, causal=True),
            qkv)
        for name, (fn, ins) in cases.items():
            got = []
            for f in (fn, torch.compile(fn, backend="aot_eager",
                                        fullgraph=True)):
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in ins]
                y = f(*leaves)
                w = torch.linspace(0.5, 1.5, y.numel(),
                                   device=dev).reshape(y.shape)
                (y.float() * w).sum().backward()
                got.append([t.grad for t in leaves])
                torch._dynamo.reset()
            out["%s %s" % (dev, name)] = [
                None if c is None else float((c - e).norm() / e.norm())
                for c, e in zip(*reversed(got))]
    return out


def _step(variant, fn, x, y, params):
    from mxnet_tpu_torch import autograd

    for p in params:
        p.zero_grad()
    with autograd.record():
        loss = fn(x, y)
    tensors = [p._tensor() for p in params]
    if variant == "plain":
        loss.float().sum().backward()
    elif variant == "grad":
        gs = torch.autograd.grad(loss.float().sum(), tensors,
                                 allow_unused=True)
        return [torch.zeros_like(t).float() if g is None else g.float()
                for t, g in zip(tensors, gs)]
    else:
        autograd.backward(loss)
    return [t.grad.clone().float() for t in tensors]


def main(variants):
    from mxnet_tpu_torch import amp, gluon
    from mxnet_tpu_torch.models.gpt import GPTModel
    from mxnet_tpu_torch.ops.cuda import IMPLS, _build

    _build.extension()
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda", 0)
    seq = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50257, (8, 1025)).astype(np.int32)).to(dev)
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
    saved = dict(IMPLS)
    if "functions" in variants:
        for case, errs in _functions().items():
            print("functions", case, errs, flush=True)
        variants = [v for v in variants if v != "functions"]
    for dt in ("float32", "bfloat16"):
        m = GPTModel(vocab_size=50257, units=768, num_layers=2,
                     num_heads=12, max_length=1024, dropout=0.0)
        m.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
        if dt == "bfloat16":
            amp.convert_hybrid_block(m, "bfloat16")
        params = list(m.collect_params().values())
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

        def f(a, b):
            return loss_fn(m(a), b)

        for variant in variants:
            IMPLS.update(saved)
            if variant in _OFF:
                IMPLS.update(_plain_impls(_OFF[variant]))
            torch._dynamo.reset()
            log = []
            compiled = torch.compile(f, backend=_inputs_backend(log),
                                     fullgraph=True)
            base = "plain" if variant in ("plain", "grad") else "record"
            eager = _step(base if variant != "grad" else "grad", f, x, y,
                          params)
            got = _step(variant if variant in ("plain", "grad") else
                        "record", compiled, x, y, params)
            rows = sorted(((float((a - b).norm() / b.norm().clamp(
                min=1e-30)), p.name, float(a.norm()), float(b.norm()))
                for p, a, b in zip(params, got, eager)), reverse=True)
            bad = [r for r in rows if r[0] > 1e-2]
            print(dt, variant, "graph inputs", log, "parameters apart",
                  len(bad), "of", len(rows), bad, "best", rows[-1],
                  flush=True)
        IMPLS.update(saved)
        del m, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or VARIANTS))
