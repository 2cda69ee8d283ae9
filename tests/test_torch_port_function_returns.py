"""The port's ``torch.autograd.Function``s return from their forward a
tensor an op made, never one an op handed back as it was: a ``.to()`` or
``.float()`` to the dtype it already has, ``.contiguous()`` of a contiguous
tensor, an in-place op's result; nor their own input's memory.
``torch.compile`` on torch 2.11 drops the backward of such a Function, so
its inputs get no gradient through it (``base.cast_out``); a GPT-2 step
compiled there lost the attention's and the embedding lookup's gradients.
Each case runs its Function on the CPU under a mode that notes every op
result that is one of the op's own tensor arguments, and holds the
Function's output against those and against the inputs' memory; the
planted Functions that return a no-op ``.to()`` and an in-place result are
caught. The Functions' values are held against the JAX package in the
other parity files."""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from mxnet_tpu_torch.base import cast_out
from mxnet_tpu_torch.gluon.contrib.nn import _SyncBatchNormFn
from mxnet_tpu_torch.ops import attention as A
from mxnet_tpu_torch.ops import extra as X
from mxnet_tpu_torch.ops import functional as Fn
from mxnet_tpu_torch.parallel.expert_parallel import _Mean


class _HandedBack(TorchFunctionMode):
    """Notes the ids of op results that are one of the op's arguments."""

    def __init__(self):
        super().__init__()
        self.ids = set()
        self.leaves = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = [a for a in list(args) + list((kwargs or {}).values())
                 if isinstance(a, torch.Tensor)]
        if isinstance(out, torch.Tensor) and any(out is a for a in given):
            self.ids.add(id(out))
        self.leaves.extend(a for a in given
                           if a.is_leaf and a.requires_grad)
        return out


def _returns(fn, *args):
    """(outputs of ``fn(*args)``, the ids of tensors an op handed back)."""
    with _HandedBack() as mode:
        out = fn(*args)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o for o in outs if isinstance(o, torch.Tensor)], mode.ids


def _t(shape, dtype=torch.float32, seed=0, grad=True):
    x = torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)
    return x.requires_grad_(grad)


def _bn(dtype):
    x = _t((4, 3, 5), dtype)
    xf = x.detach().float()
    mean, var = xf.mean((0, 2)), xf.var((0, 2), unbiased=False)
    return _SyncBatchNormFn.apply(x, _t((3,), seed=1), _t((3,), seed=2),
                                  torch.tensor(20.0), mean, var, 1e-5, None,
                                  1)


CASES = {
    "Embedding": lambda dt: Fn._Embedding.apply(
        torch.tensor([0, 3, -1, 7, 2, 9, 12]), _t((8, 6), dt)),
    "dense_attention causal": lambda dt: A.dense_attention(
        _t((1, 2, 8, 4), dt), _t((1, 2, 8, 4), dt, 1), _t((1, 2, 8, 4), dt, 2),
        causal=True),
    "dense_attention mask": lambda dt: A.dense_attention(
        _t((1, 2, 8, 4), dt), _t((1, 2, 8, 4), dt, 1), _t((1, 2, 8, 4), dt, 2),
        torch.arange(8)[None, None, None, :] < 5),
    "LinearRegressionOutput": lambda dt: X.LinearRegressionOutput(
        _t((4, 3), dt), _t((4, 3), dt, 1, grad=False)),
    "MAERegressionOutput": lambda dt: X.MAERegressionOutput(
        _t((4, 3), dt), _t((4, 3), dt, 1, grad=False)),
    "LogisticRegressionOutput": lambda dt: X.LogisticRegressionOutput(
        _t((4, 3), dt), _t((4, 3), dt, 1, grad=False)),
    "SVMOutput": lambda dt: X.SVMOutput(_t((4, 3), dt),
                                        torch.tensor([0, 2, 1, 1])),
    "MakeLoss": lambda dt: X.MakeLoss(_t((4, 3), dt)),
    "IdentityAttachKLSparseReg": lambda dt: X.IdentityAttachKLSparseReg(
        _t((4, 3), dt).sigmoid()),
    "SoftmaxOutput": lambda dt: Fn.SoftmaxOutput(_t((4, 3), dt)),
    "SyncBatchNorm": _bn,
    "expert mean": lambda dt: _Mean.apply(_t((4, 3), dt), []),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_returns_a_made_tensor(name, dtype):
    made = []
    with _HandedBack() as mode:
        out = CASES[name](dtype)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        assert id(o) not in mode.ids, (
            "%s returns a tensor an op handed back as it was" % name)
        assert o.grad_fn is not None
        # nor an input's memory (an identity forward returning its input)
        for leaf in mode.leaves:
            assert o.untyped_storage().data_ptr() != \
                leaf.untyped_storage().data_ptr(), (
                    "%s returns its input's memory" % name)
        made.append(o)
    assert made


class _Planted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return (x * 2).to(x.dtype)  # a no-op .to(): the pattern refused

    @staticmethod
    def backward(ctx, g):
        return g * 2


class _PlantedInPlace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return (x * 2).mul_(1.0)

    @staticmethod
    def backward(ctx, g):
        return g * 2


@pytest.mark.parametrize("fn", [_Planted, _PlantedInPlace],
                         ids=["no-op to", "in place"])
def test_the_mode_catches_a_planted_return(fn):
    outs, handed_back = _returns(fn.apply, _t((4, 3)))
    assert id(outs[0]) in handed_back


def test_cast_out():
    x = torch.ones(3) * 2
    assert cast_out(x, torch.float32) is x
    y = cast_out(x, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y is not x
