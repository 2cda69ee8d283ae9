"""The limits ``chip_smoke.py`` holds the training kernels to on the card,
checked on the CPU: an honest re-rounding passes (the same arithmetic in
float64, rounded to bf16 at the kernels' cast points), and faults of the
kind a kernel can have are caught: a scale off by 1 %, a dropped 64-key
K/V tile at vl 512, a non-zero dk row past the valid length, and a label
read one column off."""
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

T = 512
SCALE = 1.0 / 8


# ---------------------------------------------------------- softmax-xent


def _xent_case():
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(64, 3000, generator=g) * 3).to(torch.bfloat16)
    labels = torch.randint(0, 3000, (64,), generator=g, dtype=torch.int32)
    dy = torch.randn(64, generator=g)
    return x, labels, dy


def _xent_dx_f64(x, labels, lse, dy):
    """The backward's arithmetic in float64, rounded once to bf16."""
    xd = x.double()
    onehot = torch.zeros_like(xd)
    onehot[torch.arange(x.shape[0]), labels.long()] = 1.0
    p = torch.exp(xd - lse.double()[:, None])
    dx = (p - onehot) * dy.double()[:, None]
    return dx.to(x.dtype)


XENT_DX_FAULTS = {
    "dx x1.01": lambda x, lab, lse, dy: sx.softmax_xent_bwd_plain(
        x, lab, lse, dy * 1.01),
    "label one column off": lambda x, lab, lse, dy: sx.softmax_xent_bwd_plain(
        x, (lab + 1) % x.shape[1], lse, dy),
}


def test_xent_dx_tolerance_passes_honest_rounding():
    x, labels, dy = _xent_case()
    _, lse = sx.softmax_xent_fwd_plain(x, labels)
    ref = sx.softmax_xent_bwd_plain(x, labels, lse, dy)
    reading = cs.held(_xent_dx_f64(x, labels, lse, dy), ref,
                      cs.XENT_DX_TOL["bfloat16"], "float64 re-rounding")
    assert reading["worst_ratio"] <= 1.0


@pytest.mark.parametrize("fault", list(XENT_DX_FAULTS))
def test_xent_dx_tolerance_catches_faults(fault):
    x, labels, dy = _xent_case()
    _, lse = sx.softmax_xent_fwd_plain(x, labels)
    ref = sx.softmax_xent_bwd_plain(x, labels, lse, dy)
    got = XENT_DX_FAULTS[fault](x, labels, lse, dy)
    with pytest.raises(cs.SmokeFailure):
        cs.held(got, ref, cs.XENT_DX_TOL["bfloat16"], fault)


@pytest.mark.parametrize("fault", ["loss x1.01", "label one column off"])
def test_xent_loss_tolerance_catches_faults(fault):
    x, labels, _ = _xent_case()
    ref, _ = sx.softmax_xent_fwd_plain(x, labels)
    if fault == "loss x1.01":
        got = ref * 1.01
    else:
        got, _ = sx.softmax_xent_fwd_plain(x, (labels + 1) % x.shape[1])
    cs.held(ref, ref, cs.XENT_TOL, "no fault")
    with pytest.raises(cs.SmokeFailure):
        cs.held(got, ref, cs.XENT_TOL, fault)


# ---------------------------------------------------------- flash backward


def _flash_case():
    vl = torch.full((2,), T, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    return vl, cs.flash_bwd_inputs("cpu", g, 2, 4, T, 64, vl)


def _flash_bwd_f64(q, k, v, do, lse, delta, vl):
    """dq, dk, dv with the kernels' cast points (ds and p rounded to bf16
    before their products, outputs rounded to bf16), the rest in float64."""
    B, H, Tq, _ = q.shape
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    s = torch.matmul(qd, kd.transpose(-1, -2)) * SCALE
    keep = torch.arange(T)[None, None, None, :] < vl.reshape(B, 1, 1, 1)
    p = torch.where(keep, torch.exp(s - lse.double().reshape(B, H, Tq, 1)),
                    0.0)
    dp = torch.matmul(dod, vd.transpose(-1, -2))
    ds = p * (dp - delta.double().reshape(B, H, Tq, 1))
    dsb = ds.to(torch.bfloat16).double()
    dq = torch.matmul(dsb, kd) * SCALE
    dk = torch.matmul(dsb.transpose(-1, -2), qd) * SCALE
    dv = torch.matmul(p.to(torch.bfloat16).double().transpose(-1, -2), dod)
    return [t.to(torch.bfloat16) for t in (dq, dk, dv)]


def _flash_bwd_plain(args, vl, scale=SCALE):
    return list(fa.flash_attention_bwd_plain(*args, kv_valid_len=vl,
                                             scale=scale))


FLASH_FAULTS = {
    "scale x1.01": lambda args, vl: _flash_bwd_plain(args, vl, SCALE * 1.01),
    "last K/V tile dropped": lambda args, vl: _flash_bwd_plain(args, vl - 64),
}


def test_flash_bwd_tolerance_passes_honest_rounding():
    vl, args = _flash_case()
    refs = _flash_bwd_plain(args, vl)
    mags = cs.flash_bwd_magnitudes(*args, vl=vl)
    for got, ref, mag, name in zip(_flash_bwd_f64(*args, vl), refs, mags,
                                   ("dq", "dk", "dv")):
        assert bool((mag >= ref.float().abs() - 1e-6).all())
        reading = cs.held(got, ref, cs.FLASH_BWD_TOL, "float64 " + name, mag)
        assert reading["worst_ratio"] <= 0.5


@pytest.mark.parametrize("fault", list(FLASH_FAULTS))
@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_flash_bwd_tolerance_catches_faults(fault, which):
    vl, args = _flash_case()
    ref = _flash_bwd_plain(args, vl)[which]
    mag = cs.flash_bwd_magnitudes(*args, vl=vl)[which]
    got = FLASH_FAULTS[fault](args, vl)[which]
    with pytest.raises(cs.SmokeFailure):
        cs.held(got, ref, cs.FLASH_BWD_TOL, fault, mag)


def test_flash_bwd_tolerance_catches_nonzero_dk_row_past_vl():
    vl, args = _flash_case()
    vl = vl - 1  # key T - 1 is past the valid length
    ref = _flash_bwd_plain(args, vl)[1]
    mag = cs.flash_bwd_magnitudes(*args, vl=vl)[1]
    assert not ref[:, :, T - 1].any()
    got = ref.clone()
    got[:, :, T - 1] = 1e-3
    with pytest.raises(cs.SmokeFailure):
        cs.held(got, ref, cs.FLASH_BWD_TOL, "dk row past vl", mag)


# ---------------------------------------------------------- planted faults


def _planted_case(wrapper):
    """(the wrapper's inputs, its plain version's outputs, the limit, the
    magnitude of each output) at a small size."""
    from mxnet_tpu_torch.ops.cuda import layernorm as ln

    if wrapper == "fused_layernorm":
        g = torch.Generator().manual_seed(1)
        x = (torch.randn(64, 768, generator=g) * 2 + 0.5).to(torch.bfloat16)
        args = (x, torch.randn(768, generator=g), torch.randn(768, generator=g),
                1e-12)
        return args, [ln.layernorm_plain(*args)], cs.BF16_TOL, [None]
    if wrapper == "softmax_xent_bwd":
        x, labels, dy = _xent_case()
        _, lse = sx.softmax_xent_fwd_plain(x, labels)
        args = (x, labels, lse, dy)
        return (args, [sx.softmax_xent_bwd_plain(*args)],
                cs.XENT_DX_TOL["bfloat16"], [None])
    assert wrapper == "flash_attention_bwd"
    vl, args = _flash_case()
    return ((*args, vl), _flash_bwd_plain(args, vl), cs.FLASH_BWD_TOL,
            list(cs.flash_bwd_magnitudes(*args, vl=vl)))


@pytest.mark.parametrize("fault", [f for f, (o, _) in cs.PLANTED_FAULTS.items()
                                   if o])
def test_planted_faults_fail_their_kernel_check(fault):
    """Each fault the training step is run with is one its kernel's own
    check on the card rejects, also those the step's gradient limit cannot
    see: every output the fault changes fails its limit (the flash
    backward's faults change dq alone, or dk and dv alone)."""
    (wrapper, faulty), = cs.PLANTED_FAULTS[fault][0].items()
    args, plain, tol, mags = _planted_case(wrapper)
    got = faulty(*args)
    got = list(got) if isinstance(got, tuple) else [got]
    changed = [i for i, (g, p) in enumerate(zip(got, plain))
               if not torch.equal(g, p)]
    assert changed
    for i in changed:
        with pytest.raises(cs.SmokeFailure):
            cs.held(got[i], plain[i], tol, fault, mags[i])
