"""The flash forward's fp32 form (``csrc/flash_attention_fwd_f32.cu``)
where the CPU can check it: the split of each query tile's key range
(plain Python in the wrapper, the kernel's own arithmetic) at the served
shapes and at edge shapes, the split-and-combine arithmetic against the
plain version, and the accuracy argument of the 3xTF32 products, emulated
in torch: three TF32 products stay inside the limit ``chip_smoke.py``
holds the kernel to, one does not. The kernel itself runs only on the card
(``chip_smoke.phase_flash_f32``)."""
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.ops.cuda import flash_attention as fa

SMS = 132  # H100 SXM
SM_COUNTS = {"h100-sxm": 132, "h100-pcie": 114}
_VL = [int(n) for n in cs._bert_requests()[2]]

# (name, batch_heads, T, causal, head dim, the valid lengths served)
SERVED = [
    ("bert int8 bucket 1", 12, 512, False, 64, _VL[:1]),
    ("bert int8 bucket 4", 48, 512, False, 64, _VL[1:5]),
    ("bert int8 bucket 8", 96, 512, False, 64, _VL[5:13]),
    ("gpt int8 prefill 256", 12, 256, True, 64, None),
    ("gpt int8 prefill 512", 12, 512, True, 64, None),
    ("gpt int8 prefill 1024", 12, 1024, True, 64, None),
]
EDGE = [
    ("causal T=640", 12, 640, True, 64, None),
    ("causal T=700", 12, 700, True, 64, None),
    ("causal T=2048", 4, 2048, True, 64, None),
    ("causal T=2000", 3, 2000, True, 64, None),
    ("D=128 causal", 12, 512, True, 128, [300]),
    ("D=128 causal T=130", 2, 130, True, 128, None),
    ("vl 1 and 0", 12, 512, False, 64, [1, 0, 333]),
    ("all vl 0", 12, 512, False, 64, [0, 0, 0]),
    ("T=1", 6, 1, False, 64, None),
    ("T=1 causal", 1, 1, True, 64, None),
    ("T=65 causal", 1, 65, True, 64, None),
    ("ragged T=200", 12, 200, False, 64, [200, 0, 77]),
    ("T=5000", 1, 5000, False, 64, None),
    ("one under a wave", 65, 256, False, 64, None),
    ("one wave", 66, 256, False, 64, None),
    ("causal, two waves", 24, 1024, True, 64, None),
]
CASES = SERVED + EDGE


def _split_ranges(tq, kv_len, causal, splits, chunk, head_dim=64):
    """For each query tile, the key ranges [lo, hi) its splits run, split
    0 first, as flash_attention_fwd_f32.cu computes them (``key_tiles``,
    a split's run of ``chunk`` key tiles, the loop's end at the valid
    length): a split past the last run has no range, and a query tile with
    no valid key runs none."""
    tile = fa.F32_TILES[head_dim]
    keys = tile[1]
    out = []
    for n in fa.f32_key_tiles(tq, kv_len, causal, tile):
        end = min(n * keys, kv_len)
        out.append([(z * chunk * keys, min((z + 1) * chunk * keys, end))
                    for z in range(min(splits, math.ceil(n / chunk)))])
    return out


def _lens(T, served):
    """The valid lengths the kernel meets on the card (the split choice
    does not see them): the served ones, else 0, 1, a ragged one, T - 1
    and T."""
    return sorted(set(served or [0, 1, min(37, T), max(T - 1, 0), T]))


def _splits(bh, T, causal, D, sms=SMS):
    return fa.flash_f32_splits(bh, T, T, causal, sms, D)


@pytest.mark.parametrize("sms", SM_COUNTS.values(), ids=SM_COUNTS.keys())
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_every_key_of_every_row_in_exactly_one_split(case, sms):
    _, bh, T, causal, D, served = case
    splits, chunk = _splits(bh, T, causal, D, sms)
    rows = fa.F32_TILES[D][0]
    for kv in _lens(T, served):
        ranges = _split_ranges(T, kv, causal, splits, chunk, D)
        assert len(ranges) == math.ceil(T / rows)
        for i, tile_ranges in enumerate(ranges):
            cover = np.zeros(T + fa.F32_TILES[D][1] * chunk, np.int64)
            for lo, hi in tile_ranges:
                cover[lo:hi] += 1
            assert cover.max(initial=0) <= 1, "splits overlap"
            for r in range(i * rows, min((i + 1) * rows, T)):
                need = min(kv, r + 1) if causal else kv
                assert (cover[:need] == 1).all(), (i, r, need)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_no_split_the_combine_pass_reads_is_empty(case):
    """Query tile i runs ceil(tiles_i / chunk) splits, the combine pass
    merges exactly those (each holds at least one key), and the launch
    covers the longest query tile (the C launcher's own check)."""
    _, bh, T, causal, D, served = case
    splits, chunk = _splits(bh, T, causal, D)
    tile = fa.F32_TILES[D]
    most = max(fa.f32_key_tiles(T, T, causal, tile))
    assert splits * chunk >= most and 1 <= splits <= fa.F32_MAX_SPLITS
    for kv in _lens(T, served):
        tiles = fa.f32_key_tiles(T, kv, causal, tile)
        ranges = _split_ranges(T, kv, causal, splits, chunk, D)
        for n, tile_ranges in zip(tiles, ranges):
            assert len(tile_ranges) == math.ceil(n / chunk) <= splits
            assert all(lo < hi for lo, hi in tile_ranges)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_split_whenever_the_grid_fills_a_wave(case):
    _, bh, T, causal, D, _ = case
    rows = fa.F32_TILES[D][0]
    splits, chunk = _splits(bh, T, causal, D)
    most = max(fa.f32_key_tiles(T, T, causal, fa.F32_TILES[D]))
    if math.ceil(T / rows) * bh >= SMS:
        assert (splits, chunk) == (1, most)
    if splits > 1:
        # a split shortens the longest query tile's run
        assert chunk < most


def test_split_choice_at_the_served_shapes():
    """What the card runs on the quantized paths (chip_smoke.py checks
    which of its cases split): the batch-1 prefills at 256, 512 and 1024
    and the int8 BERT forward at bucket 1 split their key range (at 1024
    into 240 CTAs of up to 4 key tiles, the best of the split sweep on the
    card); buckets 4 and 8 fill a wave unsplit."""
    got = {name: _splits(bh, T, causal, D)
           for name, bh, T, causal, D, _ in SERVED}
    assert got == {"bert int8 bucket 1": (2, 4), "bert int8 bucket 4": (1, 8),
                   "bert int8 bucket 8": (1, 8),
                   "gpt int8 prefill 256": (4, 1),
                   "gpt int8 prefill 512": (4, 2),
                   "gpt int8 prefill 1024": (4, 4)}


def _split_flash(q, k, v, kv_valid_len, causal, splits, chunk):
    """The kernel's split-and-combine arithmetic in float64: each query
    tile's splits over the ranges of ``_split_ranges``, each an
    (unnormalized output, max, sum), merged in split order."""
    B, H, T, D = q.shape
    rows = fa.F32_TILES[D][0]
    scale = 1.0 / math.sqrt(D)
    out = torch.zeros(B, H, T, D, dtype=torch.float64)
    lse = torch.full((B, H, T), -1e30, dtype=torch.float64)
    cols = torch.arange(T)
    for b in range(B):
        kv = int(kv_valid_len[b])
        ranges = _split_ranges(T, kv, causal, splits, chunk, D)
        for i, tile_ranges in enumerate(ranges):
            r = torch.arange(i * rows, min((i + 1) * rows, T))
            qi = q[b, :, r].double()
            parts = []
            for lo, hi in tile_ranges:
                s = qi @ k[b, :, lo:hi].double().transpose(-1, -2) * scale
                keep = cols[None, lo:hi] < kv
                if causal:
                    keep = keep & (cols[None, lo:hi] <= r[:, None])
                s = torch.where(keep, s, -1e30)
                m = s.amax(-1, keepdim=True)
                p = torch.where(keep, torch.exp(s - m), 0.0)
                parts.append((p @ v[b, :, lo:hi].double(), m,
                              p.sum(-1, keepdim=True)))
            if not parts:
                continue
            mx = torch.stack([m for _, m, _ in parts]).amax(0)
            den = sum(l * torch.exp(m - mx) for _, m, l in parts)
            acc = sum(o * torch.exp(m - mx) for o, m, _ in parts)
            out[b, :, r] = acc / den.clamp(min=1e-30)
            lse[b, :, r] = torch.where(den > 0, mx + torch.log(den),
                                       -1e30)[..., 0]
    return out, lse


@pytest.mark.parametrize("B,H,T,causal,vl", [
    (1, 2, 640, True, None),
    (1, 3, 700, True, [500]),
    (3, 2, 200, False, [200, 0, 77]),
    (2, 2, 512, False, [1, 333]),
])
def test_split_and_combine_equal_the_plain_version(B, H, T, causal, vl):
    """Merging the splits' partial results gives the plain version's
    output and lse, at splits that cut the key range mid-sequence."""
    g = torch.Generator().manual_seed(5)
    q, k, v = cs._qkv("cpu", g, B, H, T, 64, torch.float32)
    vlt = torch.tensor(vl if vl else [T] * B, dtype=torch.int32)
    splits, chunk = fa.flash_f32_splits(B * H, T, T, causal, SMS, 64)
    assert splits > 1 and chunk * 64 < T
    got, got_lse = _split_flash(q, k, v, vlt, causal, splits, chunk)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_valid_len=vlt,
                                            causal=causal, return_lse=True)
    mag = cs.flash_magnitude(q, k, v, vlt, causal)
    cs.held(got, ref, cs.FLASH_F32_TOL, "split and combine", mag)
    assert cs.max_err(got_lse.reshape(-1), ref_lse.reshape(-1)) \
        <= cs.LSE_TOL


def test_tf32_rounded_is_round_to_nearest_ties_away():
    x = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -11,
                      -(1 + 2.0 ** -11), 3.0, 0.0, -0.0])
    got = cs.tf32_rounded(x)
    want = torch.tensor([1 + 2.0 ** -10, 1.0, 1 + 2 * 2.0 ** -10,
                         -(1 + 2.0 ** -10), 3.0, 0.0, -0.0])
    assert torch.equal(got, want)
    r = cs.tf32_rounded(torch.randn(1000, generator=torch.Generator()
                                    .manual_seed(0)))
    assert not bool((r.view(torch.int32) & 0x1FFF).any())


def _split3(x):
    big = cs.tf32_rounded(x)
    return big.double(), cs.tf32_rounded(x - big).double()


def _flash_3xtf32(q, k, v, vl):
    """The kernel's products emulated: every operand big + small in TF32,
    each product small * big + big * small + big * big taken exactly (in
    float64), the softmax in float64 and p rounded to fp32 before its
    split."""
    B, H, T, D = q.shape
    (qb, qs), (kb, ks), (vb, vs) = _split3(q), _split3(k), _split3(v)
    s = (qs @ kb.transpose(-1, -2) + qb @ ks.transpose(-1, -2)
         + qb @ kb.transpose(-1, -2)) / math.sqrt(D)
    keep = torch.arange(T)[None, None, None, :] < vl.reshape(B, 1, 1, 1)
    s = torch.where(keep, s, -1e30)
    p = torch.where(keep, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    pb, ps = _split3(p.float())
    o = ps @ vb + pb @ vs + pb @ vb
    return (o / l.clamp(min=1e-30)).float()


def test_3xtf32_within_the_fp32_limit_and_one_tf32_product_above():
    """At the int8 BERT bucket-8 rows' kind of input (every key valid and
    short rows), three TF32 products read inside ``FLASH_F32_TOL`` and the
    plain version on TF32-rounded operands (chip_smoke's planted reading)
    far above it."""
    g = torch.Generator().manual_seed(2)
    q, k, v = cs._qkv("cpu", g, 3, 4, 512, 64, torch.float32)
    vl = torch.tensor([512, 37, 256], dtype=torch.int32)
    ref = fa.flash_attention_plain(q, k, v, kv_valid_len=vl)
    mag = cs.flash_magnitude(q, k, v, vl)
    three = cs.held(_flash_3xtf32(q, k, v, vl), ref, cs.FLASH_F32_TOL,
                    "3xTF32 emulated", mag)
    one = cs.error_reading(
        fa.flash_attention_plain(cs.tf32_rounded(q), cs.tf32_rounded(k),
                                 cs.tf32_rounded(v), kv_valid_len=vl),
        ref, cs.FLASH_F32_TOL, "one TF32 product", mag)
    assert three["worst_ratio"] < 0.5 < 1.0 < one["worst_ratio"]


def test_the_cost_model_hands_ctas_to_the_first_free_slot():
    assert fa._makespan([], 4) == 0.0
    assert fa._makespan([3.0, 1.0], 4) == 3.0
    # two slots: 4 and 1 start at once, 2 follows 1, 3 follows that
    assert fa._makespan([4.0, 1.0, 2.0, 3.0], 2) == 6.0
