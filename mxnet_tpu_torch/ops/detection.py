"""SSD's detection ops (counterpart of ``mxnet_tpu/ops/detection.py``):
IoU, greedy NMS, anchors, multibox target assignment with hard-negative
mining, multibox decoding with per-class NMS, and bipartite matching.

Each keeps the JAX op's arguments, fixed output shapes and tie rules (ref:
src/operator/contrib/bounding_box.cc, multibox_prior.cc,
multibox_target.cc, multibox_detection.cc). Where the JAX op maps one
image with ``vmap``, the port works on the whole batch at once.

- Sorting: ``jnp.argsort`` is stable, so every sort here is
  ``torch.argsort(..., stable=True)``, and a rank is the inverse
  permutation (a scatter of ``arange``).
- NMS is the JAX op's greedy loop over all n sorted boxes, one step a box
  (batched over images), on the (B, n, n) IoU: suppressed entries keep
  their place with score -1, as MXNet's op marks them.
- ``multibox_target``'s forced matches: two ground-truth boxes may share
  a best anchor, and the JAX op's ``.at[idx].set`` then keeps the last
  write on the CPU; CUDA's ``index_put_`` with repeated indices keeps none
  in particular. The port takes the highest ground-truth index by a
  ``scatter_reduce`` of ``amax``: the same answer, on every device.
- ``multibox_target`` passes no gradient (argsorts and selections): it
  runs on detached inputs.
"""
from __future__ import annotations

import torch

from ..base import register_op


def _iou_corner(a, b):
    """a (..., M, 4), b (..., N, 4) corner format -> (..., M, N)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def _center_to_corner(b):
    xy, wh = b[..., :2], b[..., 2:]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


@register_op("box_iou", nondiff=True)
def box_iou(lhs, rhs, *, format="corner"):
    if format == "center":
        lhs = _center_to_corner(lhs)
        rhs = _center_to_corner(rhs)
    return _iou_corner(lhs, rhs)


def _inverse(order):
    """The inverse of a batch of permutations (B, n): rank[b, order[b, i]]
    = i, as ``argsort(order)``."""
    ar = torch.arange(order.shape[1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, ar)


def nms_scores(boxes, scores, ids, overlap_thresh, valid_thresh,
               force_suppress):
    """Greedy NMS over (B, n) boxes: the scores in the input order with
    every suppressed or invalid entry at -1. A box suppresses each later
    (lower-scored) box of its class whose IoU with it exceeds
    ``overlap_thresh``, if it is itself still kept."""
    n = scores.shape[1]
    order = torch.argsort(-scores, dim=1, stable=True)
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    s = torch.gather(scores, 1, order)
    c = torch.gather(ids, 1, order)
    iou = _iou_corner(b, b)
    later = torch.ones(n, n, dtype=torch.bool, device=b.device).triu_(1)
    sup = (iou > overlap_thresh) & later
    del iou
    if not force_suppress:
        sup &= c[:, :, None] == c[:, None, :]
    keep_if = ~sup
    del sup
    keep = s > valid_thresh
    for i in range(n):
        keep = torch.where(keep[:, i:i + 1], keep & keep_if[:, i], keep)
    s = torch.where(keep, s, -1.0)
    return torch.gather(s, 1, _inverse(order))


@register_op("box_nms", nondiff=True)
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=0, force_suppress=False,
            in_format="corner", out_format="corner"):
    """data (B, N, K) rows [id, score, x1, y1, x2, y2] (by the index
    arguments) -> the same, each suppressed entry's score -1 (ref:
    bounding_box.cc:BoxNMS). ``topk`` and ``out_format`` are accepted and
    not used, as in the JAX op."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    boxes = data[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    scores = data[..., score_index]
    ids = data[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    s = nms_scores(boxes, scores, ids, overlap_thresh, valid_thresh,
                   force_suppress or id_index < 0)
    out = data.clone()
    out[..., score_index] = s
    return out[0] if squeeze else out


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


@register_op("multibox_prior", nondiff=True)
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), steps=(-1.0, -1.0),
                   offsets=(0.5, 0.5), clip=False):
    """Anchor boxes of each feature-map pixel, corner format, normalized
    to [0, 1] (ref: multibox_prior.cc): (1, H*W*A, 4) fp32 on data's
    device, A = len(sizes) + len(ratios) - 1."""
    dev = data.device
    h, w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, device=dev) + offsets[0]).float() * step_y
    cx = (torch.arange(w, device=dev) + offsets[1]).float() * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cx, cy], dim=-1).reshape(-1, 2)  # (HW, 2)
    # fp32 arithmetic throughout, as the JAX op's jnp.sqrt of a python
    # float
    whs = []
    r0 = ratios[0] if len(ratios) else 1.0
    for s in sizes:
        sq = torch.sqrt(_f32(r0, dev))
        whs.append(torch.stack([s * sq, s / sq]))
    for r in ratios[1:]:
        sq = torch.sqrt(_f32(r, dev))
        whs.append(torch.stack([sizes[0] * sq, sizes[0] / sq]))
    wh = torch.stack(whs)  # (A, 2)
    a = wh.shape[0]
    ctr = centers[:, None, :].expand(-1, a, -1)
    half = wh[None, :, :] / 2
    boxes = torch.cat([ctr - half, ctr + half], dim=-1).reshape(1, -1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


@register_op("multibox_target", nondiff=True)
def multibox_target(anchors, labels, cls_preds, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=3.0,
                    negative_mining_thresh=0.5,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to ground truth and encode the regression targets
    (ref: multibox_target.cc). anchors (1, N, 4) corner; labels (B, M, 5)
    rows [cls, x1, y1, x2, y2] (cls < 0: padding); cls_preds
    (B, num_cls + 1, N). Returns (box_target (B, N*4), box_mask (B, N*4),
    cls_target (B, N)): the class + 1 at a positive anchor, 0 at a mined
    negative, ``ignore_label`` elsewhere. ``negative_mining_thresh`` is
    accepted and not used, as in the JAX op."""
    anc = anchors[0].detach()
    labels = labels.detach()
    cls_preds = cls_preds.detach()
    N = anc.shape[0]
    B, M = labels.shape[:2]
    gt_valid = labels[..., 0] >= 0  # (B, M)
    gt_boxes = labels[..., 1:5]
    iou = _iou_corner(anc[None], gt_boxes)  # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)  # the first of equal maxima
    # each valid gt's best anchor is forced positive; a padding row goes
    # to a dropped extra anchor N. Of several gts sharing a best anchor,
    # the last (highest index) wins, as the JAX op's scatter on the CPU
    best_anchor = torch.argmax(iou, dim=1)  # (B, M)
    idx = torch.where(gt_valid, best_anchor, N)
    src = torch.arange(M, device=anc.device).expand(B, M)
    winner = torch.full((B, N + 1), -1, dtype=torch.int64,
                        device=anc.device).scatter_reduce_(
        1, idx, src, reduce="amax")[:, :N]
    forced = winner >= 0
    pos = (best_iou >= overlap_threshold) | forced
    matched = torch.where(forced, winner, best_gt)  # (B, N)
    mb = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 4))
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = torch.clamp(anc[:, 2] - anc[:, 0], min=1e-8)
    ah = torch.clamp(anc[:, 3] - anc[:, 1], min=1e-8)
    gcx = (mb[..., 0] + mb[..., 2]) / 2
    gcy = (mb[..., 1] + mb[..., 3]) / 2
    gw = torch.clamp(mb[..., 2] - mb[..., 0], min=1e-8)
    gh = torch.clamp(mb[..., 3] - mb[..., 1], min=1e-8)
    tx = (gcx - acx) / aw / variances[0]
    ty = (gcy - acy) / ah / variances[1]
    tw = torch.log(gw / aw) / variances[2]
    th = torch.log(gh / ah) / variances[3]
    bt = torch.stack([tx, ty, tw, th], dim=-1)
    bt = torch.where(pos[..., None], bt, 0.0)
    bm = pos[..., None].expand_as(bt).to(bt.dtype)
    cls_t = torch.where(pos, torch.gather(labels[..., 0], 1, matched) + 1.0,
                        0.0)
    # hard-negative mining: keep the ratio * npos negatives of highest
    # non-background score
    npos = pos.sum(dim=1)
    neg_score = cls_preds[:, 1:].max(dim=1).values  # (B, N)
    neg_score = torch.where(pos, float("-inf"), neg_score)
    k = torch.clamp(npos * negative_mining_ratio, max=N - 1).to(torch.int32)
    rank = _inverse(torch.argsort(-neg_score, dim=1, stable=True))
    keep_neg = rank < k[:, None]
    cls_t = torch.where(pos | keep_neg, cls_t, ignore_label)
    return bt.reshape(B, -1), bm.reshape(B, -1), cls_t


def decode_detections(cls_prob, loc_pred, anchors, clip=True,
                      threshold=0.01, variances=(0.1, 0.1, 0.2, 0.2)):
    """``multibox_detection`` before its NMS: (B, N, 6) rows [id, score,
    x1, y1, x2, y2], the box predictions decoded against the anchors, the
    best foreground class and its probability, id and score -1 at or
    under ``threshold``."""
    anc = anchors[0]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    B = cls_prob.shape[0]
    lp = loc_pred.reshape(B, -1, 4)
    cx = lp[..., 0] * variances[0] * aw + acx
    cy = lp[..., 1] * variances[1] * ah + acy
    w = torch.exp(lp[..., 2] * variances[2]) * aw
    h = torch.exp(lp[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    fg = cls_prob[:, 1:]
    scores = fg.max(dim=1).values
    ids = torch.argmax(fg, dim=1).to(torch.float32)
    ok = scores > threshold
    ids = torch.where(ok, ids, -1.0)
    scores = torch.where(ok, scores, -1.0)
    dt = torch.promote_types(scores.dtype, boxes.dtype)
    return torch.cat([ids[..., None].to(dt), scores[..., None].to(dt),
                      boxes.to(dt)], dim=-1)


@register_op("multibox_detection", nondiff=True)
def multibox_detection(cls_prob, loc_pred, anchors, *, clip=True,
                       threshold=0.01, nms_threshold=0.5,
                       force_suppress=False, nms_topk=400,
                       variances=(0.1, 0.1, 0.2, 0.2)):
    """Decode the box predictions and run NMS over every class at once,
    boxes of different classes not suppressing each other (ref:
    multibox_detection.cc): cls_prob (B, C + 1, N), loc_pred (B, N*4),
    anchors (1, N, 4) -> (B, N, 6) rows [id, score, x1, y1, x2, y2], id and
    score -1 below ``threshold``. ``nms_topk`` is accepted and not used, as
    in the JAX op."""
    det = decode_detections(cls_prob, loc_pred, anchors, clip, threshold,
                            variances)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=threshold,
                   force_suppress=force_suppress)


@register_op("bipartite_matching", nondiff=True)
def bipartite_matching(x, *, threshold, is_ascend=False, topk=-1):
    """Greedy global bipartite matching over a (B, N, M) score matrix (ref:
    bounding_box.cc:BipartiteMatching): repeatedly pair off the best
    unused (row, column) whose score passes ``threshold`` (>= descending,
    <= with ``is_ascend``; NaN never). Returns (row_match (B, N), col_match
    (B, M)) fp32, -1 where unmatched; ``topk`` > 0 caps the matches. A
    fixed min(N, M) (or topk) steps, as the JAX op's loop; +-inf scores
    stay matchable."""
    B, N, M = x.shape
    steps = min(N, M) if topk <= 0 else min(topk, N, M)
    keyed = x * (1.0 if is_ascend else -1.0)
    avail = ((x <= threshold) if is_ascend else (x >= threshold)) \
        & ~torch.isnan(x)
    rm = torch.full((B, N), -1.0, dtype=torch.float32, device=x.device)
    cm = torch.full((B, M), -1.0, dtype=torch.float32, device=x.device)
    bi = torch.arange(B, device=x.device)
    for _ in range(steps):
        masked = torch.where(avail, keyed, float("inf"))
        flat = torch.argmin(masked.reshape(B, -1), dim=1)
        r, c = flat // M, flat % M
        valid = avail[bi, r, c]
        rm[bi, r] = torch.where(valid, c.to(torch.float32), rm[bi, r])
        cm[bi, c] = torch.where(valid, r.to(torch.float32), cm[bi, c])
        avail[bi, r, :] = avail[bi, r, :] & ~valid[:, None]
        avail[bi, :, c] = avail[bi, :, c] & ~valid[:, None]
    return rm, cm
