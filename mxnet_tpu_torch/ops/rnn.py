"""The fused recurrent op (counterpart of ``mxnet_tpu/ops/rnn.py``).

MXNet's ``RNN`` operator (ref: src/operator/rnn.cc, cuDNN on the GPU) over
per-(layer, direction) weight matrices: a multi-layer, optionally
bidirectional LSTM ``[i, f, g, o]``, GRU ``[r, z, n]`` or ``rnn_tanh`` /
``rnn_relu`` recurrence. The JAX package runs it as ``lax.scan``; here the
input projection of each layer is one GEMM over the whole sequence and the
recurrence is a Python loop of steps on the device, each step one
``torch.matmul`` and the gate arithmetic, under autograd.

The dtype rule is the JAX op's: ``h`` (the operand of the recurrent
product) is cast to the input's dtype, and the LSTM cell state ``c`` keeps
its own. Under amp the inputs are bf16 and the layers' default ``c0`` is
fp32, so the gates are bf16 and ``c`` accumulates in fp32 across the
sequence. cuDNN's LSTM takes one dtype for x, h0 and c0 and rounds ``c``
to it every step, so it computes another function and is not used.

Inter-layer dropout draws its keep masks from ``random.generator`` of the
input's device (one draw a layer, as the JAX op folds its key by layer).
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import register_op

GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def _mm(a, b):
    """a @ b in the promoted dtype of the two, as ``jnp.matmul``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _lstm_step(h, c, xw, whh_t, bhh):
    g = xw + _mm(h, whh_t) + bhh
    i, f, gg, o = g.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    gg = torch.tanh(gg)
    o = torch.sigmoid(o)
    c = f * c + i * gg  # c keeps its own dtype (fp32 under amp)
    h = o * torch.tanh(c)
    return h.to(xw.dtype), c


def _gru_step(h, xw, whh_t, bhh):
    hw = _mm(h, whh_t) + bhh
    xr, xz, xn = xw.chunk(3, dim=-1)
    hr, hz, hn = hw.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


def _single_direction(x, h0, c0, wih, whh, bih, bhh, mode):
    """x (T, N, C), h0 and c0 (N, H): the input projection of every step
    as one GEMM, then the recurrence step by step. Returns (ys (T, N, H),
    h, c)."""
    xw = _mm(x, wih.t()) + bih  # (T, N, G*H)
    whh_t = whh.t()
    h, c = h0, c0
    ys = []
    for t in range(x.shape[0]):
        if mode == "lstm":
            h, c = _lstm_step(h, c, xw[t], whh_t, bhh)
        elif mode == "gru":
            h = _gru_step(h, xw[t], whh_t, bhh)
        else:
            act = torch.tanh if mode == "rnn_tanh" else torch.relu
            h = act(xw[t] + _mm(h, whh_t) + bhh)
        ys.append(h)
    return torch.stack(ys), h, c


@register_op("_rnn_init")
def _rnn_init(x, *, num, hidden):
    """A zero initial state (num, N, hidden) in x's dtype, from x (T, N, C)
    (the ONNX importer's, when a recurrent node omits its initial
    state)."""
    return torch.zeros((num, x.shape[1], hidden), dtype=x.dtype,
                       device=x.device)


@register_op("RNN", needs_training=True)
def RNN(x, state_h, state_c, *weights, mode="lstm", num_layers=1,
        bidirectional=False, p=0.0, training=False):
    """x (T, N, C); state_h and state_c (L*D, N, H); ``weights`` per
    (layer, direction): i2h_w, h2h_w, i2h_b, h2h_b. Returns (out
    (T, N, H*D), h_n, c_n). Dropout at rate ``p`` between layers while
    ``training``."""
    if mode not in GATES:
        raise ValueError("RNN mode must be one of %s, got %r"
                         % (sorted(GATES), mode))
    D = 2 if bidirectional else 1
    if len(weights) != 4 * num_layers * D:
        raise ValueError("RNN takes 4 weights a (layer, direction): %d "
                         "given for %d x %d" % (len(weights), num_layers, D))
    state_h = state_h.to(x.dtype)
    out = x
    hs, cs = [], []
    wi = 0
    for layer in range(num_layers):
        layer_outs = []
        for d in range(D):
            idx = layer * D + d
            wih, whh, bih, bhh = weights[wi:wi + 4]
            wi += 4
            inp = torch.flip(out, dims=(0,)) if d == 1 else out
            ys, h, c = _single_direction(inp, state_h[idx], state_c[idx],
                                         wih, whh, bih, bhh, mode)
            if d == 1:
                ys = torch.flip(ys, dims=(0,))
            layer_outs.append(ys)
            hs.append(h)
            cs.append(c)
        out = torch.cat(layer_outs, dim=-1) if D == 2 else layer_outs[0]
        if p > 0.0 and training and layer < num_layers - 1:
            keep = torch.rand(out.shape, device=out.device,
                              generator=_random.generator(out.device)) \
                < 1.0 - p
            out = torch.where(keep, out / (1.0 - p), 0.0).to(out.dtype)
    return out, torch.stack(hs), torch.stack(cs)
