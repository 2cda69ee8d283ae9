"""Flat legacy registry names (counterpart of ``mxnet_tpu/ops/legacy_ops.py``):
the ``random_*``/``sample_*`` draws, the optimizer ``*_update`` kernels,
``all_finite`` and the ``multi_*`` family, the AMP casts, the ``linalg_*``
ops and the remaining aliases, as eager PyTorch.

Draws come from explicit ``torch.Generator``s: ``random.generator(device)``
on this thread, seeded by ``mx.random.seed``. Their bits cannot match the
JAX package's threefry stream; the distributions and the determinism under
a seed are what the two share. The optimizer kernels are pure (they return
the new weight and states); the ``nd`` facade writes the states back into
the arrays passed in and honours ``out=``, as MXNet's in-place ops do.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import register_op, resolve_device, resolve_dtype
from ..context import current_context
from . import functional as F

register_op("stop_gradient")(F.BlockGrad)
register_op("sum_axis")(F.sum)
register_op("crop")(F.slice)
register_op("Pad")(F.pad)
register_op("Convolution_v1")(F.Convolution)
register_op("Pooling_v1")(F.Pooling)
register_op("Softmax")(F.SoftmaxOutput)
register_op("max_axis")(F.max)
register_op("min_axis")(F.min)
register_op("BatchNorm_v1", needs_training=True)(F.BatchNorm)


@register_op("log_sigmoid")
def log_sigmoid(x):
    return torch.nn.functional.logsigmoid(x)


@register_op("mish")
def mish(x):
    return x * torch.tanh(torch.nn.functional.softplus(x))


@register_op("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    """(1,) float32: 1 iff every element of every input is finite."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.to(torch.float32).reshape(1)


@register_op("multi_sum_sq")
def multi_sum_sq(*arrays, num_arrays=None):
    return torch.stack([torch.sum(torch.square(a.to(torch.float32)))
                        for a in arrays])


@register_op("all_finite")
def all_finite(data, *, init_output=True):
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@register_op("amp_cast")
def amp_cast(x, *, dtype):
    return x.to(resolve_dtype(dtype))


@register_op("amp_multicast")
def amp_multicast(*arrays, num_outputs=None, cast_narrow=False):
    """Every float input cast to the widest (with ``cast_narrow`` the
    narrowest) float dtype among them; other inputs pass through."""
    fdts = [a.dtype for a in arrays if a.is_floating_point()]
    if not fdts:
        return list(arrays)
    bits = lambda d: torch.finfo(d).bits  # noqa: E731
    target = (min if cast_narrow else max)(fdts, key=bits)
    return [a.to(target) if a.is_floating_point() else a for a in arrays]


@register_op("onehot_encode")
def onehot_encode(indices, out_like):
    """(N,) indices → (N, C) one-hot in ``out_like``'s dtype."""
    C = out_like.shape[-1]
    cols = torch.arange(C, device=indices.device)[None, :]
    return (cols == indices.to(torch.int64)[:, None]).to(out_like.dtype)


@register_op("softmax_with_length")
def softmax_with_length(data, length, *, axis=-1, temperature=None):
    """Softmax over ``axis``, zero at positions at or past ``length``
    (shaped like data without that axis)."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    ax = axis % data.dim()
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    pos = torch.arange(data.shape[ax], device=data.device).reshape(shape)
    lshape = list(data.shape)
    lshape[ax] = 1
    valid = pos < length.to(torch.int64).reshape(lshape)
    masked = torch.where(valid, data, float("-inf"))
    return torch.where(valid, torch.softmax(masked, dim=ax), 0.0).to(
        data.dtype)


@register_op("cast_storage")
def cast_storage(data, *, stype="default"):
    """Dense storage only: ``default`` is the identity (sparse storage is
    ``ROADMAP.md`` A.17)."""
    if stype != "default":
        raise NotImplementedError(
            "cast_storage(stype=%r): sparse storage is not ported yet "
            "(ROADMAP.md A.17)" % (stype,))
    return data


# ---------------------------------------------------------------- linalg_*


def _tr(a):
    return a.transpose(-1, -2)


def k_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    if transpose_a:
        A = _tr(A)
    if transpose_b:
        B = _tr(B)
    return alpha * (A @ B)


def k_potri(L):
    """(L Lᵀ)⁻¹ from the Cholesky factor L."""
    inv_l = torch.linalg.inv(L)
    return _tr(inv_l) @ inv_l


def k_trsm(A, B, transpose=False, rightside=False, alpha=1.0, lower=True):
    if transpose:
        A = _tr(A)
        lower = not lower
    if rightside:
        return alpha * _tr(torch.linalg.solve_triangular(
            _tr(A), _tr(B), upper=lower))
    return alpha * torch.linalg.solve_triangular(A, B, upper=not lower)


def k_trmm(A, B, transpose=False, rightside=False, alpha=1.0):
    if transpose:
        A = _tr(A)
    return alpha * ((B @ A) if rightside else (A @ B))


def k_syrk(A, transpose=False, alpha=1.0):
    if transpose:
        A = _tr(A)
    return alpha * (A @ _tr(A))


def k_gelqf(A):
    """A = L Q through the QR of Aᵀ: (L, Q)."""
    q, r = torch.linalg.qr(_tr(A))
    return _tr(r), _tr(q)


register_op("linalg_gemm2")(
    lambda a, b, *, transpose_a=False, transpose_b=False, alpha=1.0:
    k_gemm2(a, b, transpose_a, transpose_b, alpha))


@register_op("linalg_gemm")
def linalg_gemm(a, b, c, *, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    return k_gemm2(a, b, transpose_a, transpose_b, alpha) + beta * c


register_op("linalg_potrf")(lambda a: torch.linalg.cholesky(a))
register_op("linalg_potri")(lambda a: k_potri(a))
register_op("linalg_det")(lambda a: torch.linalg.det(a))
register_op("linalg_inverse")(lambda a: torch.linalg.inv(a))
register_op("linalg_slogdet")(lambda a: tuple(torch.linalg.slogdet(a)))
register_op("linalg_sumlogdiag")(
    lambda a: torch.sum(torch.log(torch.diagonal(a, dim1=-2, dim2=-1)),
                        dim=-1))
register_op("linalg_extractdiag")(
    lambda a, *, offset=0: torch.diagonal(a, offset=offset, dim1=-2,
                                          dim2=-1))
register_op("linalg_makediag")(
    lambda a, *, offset=0: torch.diag_embed(a, offset=offset))
register_op("linalg_syrk")(
    lambda a, *, transpose=False, alpha=1.0: k_syrk(a, transpose, alpha))
register_op("linalg_trmm")(
    lambda a, b, *, transpose=False, rightside=False, lower=True, alpha=1.0:
    k_trmm(torch.tril(a) if lower else torch.triu(a), b, transpose,
           rightside, alpha))
register_op("linalg_trsm")(
    lambda a, b, *, transpose=False, rightside=False, lower=True, alpha=1.0:
    k_trsm(torch.tril(a) if lower else torch.triu(a), b, transpose,
           rightside, alpha, lower))
register_op("linalg_gelqf")(lambda a: k_gelqf(a))


def _trian_indices(n, offset, lower, device):
    """MXNet's la_op rule: offset > 0 the triangle above that diagonal,
    offset < 0 the one below, ``lower`` only at offset 0."""
    if offset > 0:
        return torch.triu_indices(n, n, offset, device=device)
    if offset < 0:
        return torch.tril_indices(n, n, offset, device=device)
    return (torch.tril_indices(n, n, 0, device=device) if lower
            else torch.triu_indices(n, n, 0, device=device))


@register_op("linalg_extracttrian")
def linalg_extracttrian(a, *, offset=0, lower=True):
    rows, cols = _trian_indices(a.shape[-1], offset, lower, a.device)
    return a[..., rows, cols]


@register_op("linalg_maketrian")
def linalg_maketrian(a, *, offset=0, lower=True):
    m, n = a.shape[-1], 1
    while _trian_indices(n, offset, lower, "cpu").shape[1] < m:
        n += 1
    rows, cols = _trian_indices(n, offset, lower, a.device)
    out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype, device=a.device)
    return _put_trian(out, rows, cols, a)


def _put_trian(out, rows, cols, a):
    flat = out.reshape(-1, out.shape[-2], out.shape[-1])
    vals = a.reshape(-1, a.shape[-1])
    batch = torch.arange(flat.shape[0], device=a.device)[:, None]
    res = flat.index_put((batch, rows[None, :], cols[None, :]), vals)
    return res.reshape(out.shape)


@register_op("linalg_syevd")
def linalg_syevd(a):
    """(U, lambda) with the rows of U the eigenvectors."""
    w, v = torch.linalg.eigh(a)
    return _tr(v), w


# ------------------------------------------------------------ random_* ops


def _rand_shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _gen(device):
    return _random.generator(device)


def k_uniform(shape, dtype, device, low=0.0, high=1.0):
    u = torch.rand(shape, generator=_gen(device), device=device,
                   dtype=torch.float32)
    return (low + u * (high - low)).to(dtype)


def k_normal(shape, dtype, device, loc=0.0, scale=1.0):
    z = torch.randn(shape, generator=_gen(device), device=device,
                    dtype=torch.float32)
    return (z * scale + loc).to(dtype)


def k_exponential(shape, dtype, device, scale=1.0):
    e = torch.empty(shape, device=device, dtype=torch.float32).exponential_(
        1.0, generator=_gen(device))
    return (e * scale).to(dtype)


def k_standard_gamma(alpha, shape, device):
    """Gamma(alpha, 1) draws by Marsaglia and Tsang's method (alpha < 1
    boosted by U^(1/alpha)), every draw from the thread's generator.
    ``alpha`` is a float or a tensor broadcastable to ``shape``."""
    gen = _gen(device)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    a = torch.broadcast_to(a, shape).contiguous()
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        z = torch.randn(shape, generator=gen, device=device)
        u = torch.rand(shape, generator=gen, device=device)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-38))
                        < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-38)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(shape, generator=gen, device=device)
    return torch.where(boost, out * u.clamp_min(1e-38) ** (1.0 / a), out)


def k_gamma(shape, dtype, device, alpha=1.0, beta=1.0):
    return (k_standard_gamma(alpha, shape, device) * beta).to(dtype)


def k_poisson(shape, dtype, device, lam=1.0):
    rates = torch.broadcast_to(torch.as_tensor(
        lam, dtype=torch.float32, device=device), shape).contiguous()
    return torch.poisson(rates, generator=_gen(device)).to(dtype)


def k_negative_binomial(shape, dtype, device, k=1, p=0.5):
    """NB(k, p) = Poisson(Gamma(k, (1 - p) / p))."""
    lam = k_standard_gamma(float(k), shape, device) * ((1.0 - p) / p)
    return k_poisson(shape, dtype, device, lam)


def k_randint(shape, dtype, device, low, high):
    return torch.randint(int(low), int(high), shape, generator=_gen(device),
                         device=device, dtype=torch.int64).to(dtype)


def _k_gnb(shape, dtype, device, mu=1.0, alpha=1.0):
    """Gamma-Poisson mixture: lam ~ Gamma(1/alpha, mu·alpha), x ~
    Poisson(lam); alpha 0 is Poisson(mu)."""
    if alpha <= 0:
        return k_poisson(shape, dtype, device, mu)
    lam = k_standard_gamma(1.0 / alpha, shape, device) * (mu * alpha)
    return k_poisson(shape, dtype, device, lam)


def _reg_random(name, sampler):
    def op(*, shape=(1,), dtype="float32", ctx=None, **kw):
        device = resolve_device(ctx or current_context())
        return sampler(_rand_shape(shape),
                       resolve_dtype(dtype) or torch.float32, device, **kw)

    op.__name__ = name
    register_op(name)(op)
    return op


random_uniform = _reg_random("random_uniform", k_uniform)
random_normal = _reg_random("random_normal", k_normal)
random_exponential = _reg_random(
    "random_exponential",
    lambda shp, dt, dev, lam=1.0: k_exponential(shp, dt, dev, 1.0 / lam))
random_gamma = _reg_random("random_gamma", k_gamma)
random_poisson = _reg_random("random_poisson", k_poisson)
random_negative_binomial = _reg_random("random_negative_binomial",
                                       k_negative_binomial)
random_generalized_negative_binomial = _reg_random(
    "random_generalized_negative_binomial", _k_gnb)
register_op("normal")(random_normal)
register_op("uniform")(random_uniform)
register_op("exponential")(random_exponential)
register_op("poisson")(random_poisson)


@register_op("random_randint")
def random_randint(*, low, high, shape=(1,), dtype="int32", ctx=None):
    return k_randint(_rand_shape(shape), resolve_dtype(dtype) or torch.int32,
                     resolve_device(ctx or current_context()), low, high)


def _sample_expand(param, shape):
    extra = _rand_shape(shape) if shape else ()
    return extra, tuple(param.shape) + extra


def _bc(param, extra):
    return param.reshape(tuple(param.shape) + (1,) * len(extra))


@register_op("sample_uniform")
def sample_uniform(low, high, *, shape=(), dtype="float32"):
    extra, out_shape = _sample_expand(low, shape)
    u = k_uniform(out_shape, resolve_dtype(dtype) or torch.float32,
                  low.device)
    return _bc(low, extra) + u * _bc(high - low, extra)


@register_op("sample_normal")
def sample_normal(mu, sigma, *, shape=(), dtype="float32"):
    extra, out_shape = _sample_expand(mu, shape)
    z = k_normal(out_shape, resolve_dtype(dtype) or torch.float32, mu.device)
    return _bc(mu, extra) + z * _bc(sigma, extra)


@register_op("sample_exponential")
def sample_exponential(lam, *, shape=(), dtype="float32"):
    extra, out_shape = _sample_expand(lam, shape)
    e = k_exponential(out_shape, resolve_dtype(dtype) or torch.float32,
                      lam.device)
    return e / _bc(lam, extra)


@register_op("sample_gamma")
def sample_gamma(alpha, beta, *, shape=(), dtype="float32"):
    extra, out_shape = _sample_expand(alpha, shape)
    g = k_standard_gamma(_bc(alpha, extra), out_shape, alpha.device)
    return (g * _bc(beta, extra)).to(resolve_dtype(dtype) or torch.float32)


@register_op("sample_poisson")
def sample_poisson(lam, *, shape=(), dtype="float32"):
    extra, out_shape = _sample_expand(lam, shape)
    return k_poisson(out_shape, resolve_dtype(dtype) or torch.float32,
                     lam.device, _bc(lam, extra))


def multinomial_draw(data, shape, dtype):
    """Index draws from the probability rows of ``data`` (..., K), with
    ``shape`` draws per row; also the log-probability rows."""
    extra = _rand_shape(shape) if shape else ()
    n = max(math.prod(extra), 1)
    probs = data.reshape(-1, data.shape[-1]).to(torch.float32)
    draws = torch.multinomial(probs, n, replacement=True,
                              generator=_gen(data.device))
    lead = tuple(data.shape[:-1])
    out = draws.reshape(lead + extra) if extra else draws.reshape(lead)
    logits = torch.log(torch.clamp(data.to(torch.float32), min=1e-30))
    return out.to(resolve_dtype(dtype) or torch.int32), logits


@register_op("sample_multinomial")
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32"):
    if get_prob:
        raise ValueError("get_prob=True resolves to the 2-output op "
                         "'_sample_multinomial_prob' (the nd facade does "
                         "this automatically)")
    return multinomial_draw(data, shape, dtype)[0]


@register_op("_sample_multinomial_prob")
def _sample_multinomial_prob(data, *, shape=(), dtype="int32"):
    out, logits = multinomial_draw(data, shape, dtype)
    lp = torch.take_along_dim(
        torch.log_softmax(logits, dim=-1),
        out.reshape(tuple(data.shape[:-1]) + (-1,)).to(torch.int64),
        dim=-1).reshape(out.shape)
    return out, lp


# ------------------------------------------------- optimizer update kernels


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register_op("sgd_update")
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    return weight - lr * g


@register_op("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register_op("adam_update")
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    return weight - lr * m / (torch.sqrt(v) + epsilon), m, v


def _lamb_moments(g, mean, var, beta1, beta2, epsilon, t, bias_correction):
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    if bias_correction:
        mh, vh = m / (1.0 - beta1 ** t), v / (1.0 - beta2 ** t)
    else:
        mh, vh = m, v
    return mh / (torch.sqrt(vh) + epsilon), m, v


@register_op("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, var, *, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's direction (adam moments + decoupled wd, no lr):
    (g, new_mean, new_var)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    d, m, v = _lamb_moments(g, mean, var, beta1, beta2, epsilon, t,
                            bias_correction)
    return d + wd * weight, m, v


def _lamb_trust(r1, r2, lr, lower_bound, upper_bound):
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, 1.0)
    return lr * ratio


@register_op("lamb_update_phase2")
def lamb_update_phase2(weight, g, r1, r2, *, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    return weight - _lamb_trust(r1, r2, lr, lower_bound, upper_bound) * g


@register_op("mp_lamb_update_phase1")
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, *, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    g = _clip(grad.to(torch.float32) * rescale_grad, clip_gradient)
    d, m, v = _lamb_moments(g, mean, var, beta1, beta2, epsilon, t,
                            bias_correction)
    return d + wd * weight32, m, v


@register_op("mp_lamb_update_phase2")
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, *, lr,
                          lower_bound=-1.0, upper_bound=-1.0):
    new32 = weight32 - _lamb_trust(r1, r2, lr, lower_bound, upper_bound) * g
    return new32.to(weight.dtype), new32


@register_op("multi_lars")
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, *, eta, eps,
               rescale_grad=1.0):
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    ratio = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wds * w_norm + eps), 1.0)
    return lrs * ratio


@register_op("rmsprop_update")
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    return weight - lr * g / torch.sqrt(new_n + epsilon), new_n


@register_op("signsgd_update")
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register_op("signum_update")
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom - (1 - momentum) * g
    return (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom), new_mom


@register_op("ftrl_update")
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


@register_op("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    g = _clip(grad.to(torch.float32) * rescale_grad, clip_gradient) \
        + wd * weight32
    new32 = weight32 - lr * g
    return new32.to(weight.dtype), new32


@register_op("mp_sgd_mom_update")
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _clip(grad.to(torch.float32) * rescale_grad, clip_gradient) \
        + wd * weight32
    new_mom = momentum * mom - lr * g
    new32 = weight32 + new_mom
    return new32.to(weight.dtype), new_mom, new32


@register_op("nag_mom_update")
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register_op("mp_nag_mom_update")
def mp_nag_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad.to(torch.float32) * rescale_grad, clip_gradient) \
        + wd * weight32
    new_mom = momentum * mom + g
    new32 = weight32 - lr * (g + momentum * new_mom)
    return new32.to(weight.dtype), new_mom, new32


@register_op("ftml_update")
def ftml_update(weight, grad, d, v, z, *, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    g = _clip(grad * rescale_grad, clip_grad) + wd * weight
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (
        torch.sqrt(new_v / (1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


@register_op("rmspropalex_update")
def rmspropalex_update(weight, grad, n, g, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    grd = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(grd)
    new_g = gamma1 * g + (1 - gamma1) * grd
    new_delta = gamma2 * delta - lr * grd / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight + new_delta
    if clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta


def _multi_sgd(arrays, stride, lrs, wds, rescale_grad, clip_gradient,
               momentum=None, mp=False):
    """The multi_/preloaded_multi_ SGD family: groups of ``stride`` arrays
    per weight; the new weights first, then the new states group-major."""
    ws, states = [], []
    for i in range(len(arrays) // stride):
        grp = arrays[stride * i:stride * i + stride]
        w, grad = grp[0], grp[1]
        w32 = grp[-1] if mp else w
        g = _clip(grad.to(w32.dtype) * rescale_grad, clip_gradient) \
            + wds[i] * w32
        if momentum is None:
            new32 = w32 - lrs[i] * g
            ws.append(new32.to(w.dtype))
            if mp:
                states.append(new32)
        else:
            new_mom = momentum * grp[2] - lrs[i] * g
            new32 = w32 + new_mom
            ws.append(new32.to(w.dtype))
            states.append(new_mom)
            if mp:
                states.append(new32)
    return ws + states


@register_op("multi_sgd_update")
def multi_sgd_update(*arrays, lrs, wds, num_weights=None, rescale_grad=1.0,
                     clip_gradient=-1.0):
    return _multi_sgd(arrays, 2, lrs, wds, rescale_grad, clip_gradient)


@register_op("multi_sgd_mom_update")
def multi_sgd_mom_update(*arrays, lrs, wds, momentum=0.0, num_weights=None,
                         rescale_grad=1.0, clip_gradient=-1.0):
    return _multi_sgd(arrays, 3, lrs, wds, rescale_grad, clip_gradient,
                      momentum=momentum)


@register_op("multi_mp_sgd_update")
def multi_mp_sgd_update(*arrays, lrs, wds, num_weights=None,
                        rescale_grad=1.0, clip_gradient=-1.0):
    return _multi_sgd(arrays, 3, lrs, wds, rescale_grad, clip_gradient,
                      mp=True)


@register_op("multi_mp_sgd_mom_update")
def multi_mp_sgd_mom_update(*arrays, lrs, wds, momentum=0.0,
                            num_weights=None, rescale_grad=1.0,
                            clip_gradient=-1.0):
    return _multi_sgd(arrays, 4, lrs, wds, rescale_grad, clip_gradient,
                      momentum=momentum, mp=True)


@register_op("preloaded_multi_sgd_update")
def preloaded_multi_sgd_update(*arrays, num_weights=None, rescale_grad=1.0,
                               clip_gradient=-1.0):
    """[w0, g0, w1, g1, ..., lrs, wds] with lrs and wds on the device: the
    new weights."""
    return _multi_sgd(arrays[:-2], 2, arrays[-2], arrays[-1], rescale_grad,
                      clip_gradient)


@register_op("preloaded_multi_sgd_mom_update")
def preloaded_multi_sgd_mom_update(*arrays, momentum=0.0, num_weights=None,
                                   rescale_grad=1.0, clip_gradient=-1.0):
    return _multi_sgd(arrays[:-2], 3, arrays[-2], arrays[-1], rescale_grad,
                      clip_gradient, momentum=momentum)


@register_op("preloaded_multi_mp_sgd_update")
def preloaded_multi_mp_sgd_update(*arrays, num_weights=None,
                                  rescale_grad=1.0, clip_gradient=-1.0):
    return _multi_sgd(arrays[:-2], 3, arrays[-2], arrays[-1], rescale_grad,
                      clip_gradient, mp=True)


@register_op("preloaded_multi_mp_sgd_mom_update")
def preloaded_multi_mp_sgd_mom_update(*arrays, momentum=0.0,
                                      num_weights=None, rescale_grad=1.0,
                                      clip_gradient=-1.0):
    return _multi_sgd(arrays[:-2], 4, arrays[-2], arrays[-1], rescale_grad,
                      clip_gradient, momentum=momentum, mp=True)


# no gradient through these, as in the JAX package
for _name in ("multi_all_finite", "multi_sum_sq", "all_finite",
              "onehot_encode", "multi_lars", "sgd_update", "sgd_mom_update",
              "adam_update", "lamb_update_phase1", "lamb_update_phase2",
              "mp_lamb_update_phase1", "mp_lamb_update_phase2",
              "rmsprop_update", "signsgd_update", "signum_update",
              "ftrl_update", "mp_sgd_update", "mp_sgd_mom_update",
              "nag_mom_update", "mp_nag_mom_update", "ftml_update",
              "rmspropalex_update", "multi_sgd_update",
              "multi_sgd_mom_update", "multi_mp_sgd_update",
              "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
              "preloaded_multi_sgd_mom_update",
              "preloaded_multi_mp_sgd_update",
              "preloaded_multi_mp_sgd_mom_update"):
    globals()[_name].nondiff = True
