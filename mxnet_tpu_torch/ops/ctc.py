"""The CTC loss under its ``nd`` names ``CTCLoss``/``ctc_loss``
(counterpart of ``mxnet_tpu/ops/ctc.py``; ref:
src/operator/contrib/ctc_loss.cc).

The JAX package's own recursion: the forward (alpha) algorithm over the
blank-extended labels in log space, one step a time step, each step the
log-sum-exp of three predecessors with every exponent bounded so that the
gradient stays finite where a branch is the -1e30 stand-in for minus
infinity. Autograd differentiates the recursion, as the JAX package's
autodiff does its scan. ``gluon.loss.CTCLoss`` keeps its own form.
"""
from __future__ import annotations

import torch

from ..base import register_op

NEG = -1e30


def _logsumexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    live = m > NEG / 2
    m_safe = torch.where(live, m, torch.zeros_like(m))
    # bound every exponent so the gradient stays finite past a dead branch
    sa = torch.where(a > NEG / 2, a - m_safe, torch.full_like(a, -40.0))
    sb = torch.where(b > NEG / 2, b - m_safe, torch.full_like(b, -40.0))
    sc = torch.where(c > NEG / 2, c - m_safe, torch.full_like(c, -40.0))
    out = m_safe + torch.log(torch.exp(sa) + torch.exp(sb) + torch.exp(sc))
    return torch.where(live, out, torch.full_like(out, NEG))


@register_op("CTCLoss")
def CTCLoss(pred, label, pred_lengths=None, label_lengths=None, *, blank=0):
    """``pred`` (N, T, V) unnormalized, ``label`` (N, L) int padded past
    ``label_lengths``; the per-sample loss (N,) in float32, with the blank
    first (``mx.gluon.loss.CTCLoss``'s ``blank_label='first'``)."""
    N, T, V = pred.shape
    L = label.shape[1]
    S = 2 * L + 1
    dev = pred.device
    logp = torch.log_softmax(pred.to(torch.float32), dim=-1)
    label = label.to(torch.int64)
    pred_lengths = (torch.full((N,), T, dtype=torch.int64, device=dev)
                    if pred_lengths is None else pred_lengths.to(torch.int64))
    label_lengths = (torch.full((N,), L, dtype=torch.int64, device=dev)
                     if label_lengths is None
                     else label_lengths.to(torch.int64))

    # the extended labels: blank, l1, blank, l2, ..., blank
    s_idx = torch.arange(S, device=dev)
    lab_pos = torch.clamp_min(torch.div(s_idx - 1, 2, rounding_mode="floor"),
                              0)
    ext = torch.where((s_idx % 2 == 0)[None, :],
                      torch.full((N, S), blank, dtype=torch.int64,
                                 device=dev),
                      label.gather(1, lab_pos[None, :].expand(N, S)))
    # the skip s-2 -> s where ext[s] is no blank and differs from ext[s-2]
    ext_m2 = torch.cat([torch.full((N, 2), blank, dtype=torch.int64,
                                   device=dev), ext], dim=1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)

    neg1 = torch.full((N, 1), NEG, dtype=torch.float32, device=dev)
    alpha = torch.cat([logp[:, 0, blank:blank + 1],
                       logp[:, 0].gather(1, ext[:, 1:2]),
                       neg1.expand(N, S - 2)], dim=1)
    neg2 = neg1.expand(N, 2)
    for t in range(1, T):
        lp_t = logp[:, t].gather(1, ext)
        a1 = torch.cat([neg1, alpha[:, :S - 1]], dim=1)
        a2 = torch.cat([neg2, alpha[:, :S - 2]], dim=1)
        a2 = torch.where(can_skip, a2, torch.full_like(a2, NEG))
        new = _logsumexp3(alpha, a1, a2) + lp_t
        # frozen past each sample's input length
        alpha = torch.where((t < pred_lengths)[:, None], new, alpha)
    # the last label or the blank after it
    end = 2 * label_lengths
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_end1 = alpha.gather(1, torch.clamp_min(end - 1, 0)[:, None])[:, 0]
    m = torch.maximum(a_end, a_end1)
    m_safe = torch.where(m > NEG / 2, m, torch.zeros_like(m))
    se = torch.where(a_end > NEG / 2, a_end - m_safe,
                     torch.full_like(a_end, -40.0))
    se1 = torch.where(a_end1 > NEG / 2, a_end1 - m_safe,
                      torch.full_like(a_end1, -40.0))
    return -(m_safe + torch.log(torch.exp(se) + torch.exp(se1)))
