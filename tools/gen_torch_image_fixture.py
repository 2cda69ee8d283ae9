#!/usr/bin/env python3
"""Write the image fixture the port's image tests and ``chip_smoke.py``
read, from a fixed seed, with the JAX package and PIL:

    JAX_PLATFORMS=cpu python tools/gen_torch_image_fixture.py [OUT_DIR]

OUT_DIR defaults to ``tests/fixtures``. It writes

- ``torch_images.rec``/``.idx``: 16 JPEG records (500x375, quality 90,
  smooth seeded content, labels 0-9), packed by the JAX package's
  ``recordio.pack_img``;
- ``torch_images_det.rec``/``.idx``: 16 more with 1-6 boxes each, the label
  packed by its ``io.pack_det_label``;
- ``torch_images_ref.npz``: the sha256 of the JAX package's PIL decode of
  each record (``decode_sha``, ``det_decode_sha``) with its shape, and the
  digests of the first batch of ``ImageRecordIter`` (batch 16, 224x224
  center crop of a 256 shorter edge, mirror, ImageNet mean and std,
  ``shuffle=True`` after ``np.random.seed(ITER_SEED)``) by the JAX
  package's native route and its Python route, and by the port's Python
  route, with the share of the port's values that part from the JAX
  Python route's (a resize's uint8 truncation: one level over std); and
  by the port's Python route where the native library does not load
  (``port_fallback_batch0``: the iterator draws the native pipe's seed
  before it finds that out, as the JAX package does, so the mirror draws
  come one later than with ``force_python=True``).

A digest is the sha256 of the batch's float32 data bytes and then its
float32 label bytes. The card has no JPEG encoder: ``chip_smoke.py``
makes its larger record files by repacking these payloads with
``recordio.pack``.
"""
import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20          # the images and boxes
ITER_SEED = 7      # np.random.seed before the iterators are made
N = 16
H, W = 375, 500
QUALITY = 90
BATCH = 16
ITER_KW = dict(data_shape=(3, 224, 224), batch_size=BATCH, resize=256,
               rand_mirror=True, shuffle=True, mean_r=123.68, mean_g=116.28,
               mean_b=103.53, std_r=58.395, std_g=57.12, std_b=57.375)
NAMES = ("torch_images", "torch_images_det")


def smooth_image(rng):
    """(H, W, 3) uint8: a few low-frequency waves and soft blobs."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.empty((H, W, 3), np.float32)
    for c in range(3):
        ax, ay, ph = rng.uniform(0.004, 0.03), rng.uniform(0.004, 0.03), \
            rng.uniform(0, 6.3)
        out[..., c] = 128 + 70 * np.sin(ax * x + ay * y + ph)
    for _ in range(3):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        r = rng.uniform(30, 120)
        col = rng.uniform(-80, 80, 3).astype(np.float32)
        blob = np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * r * r))
        out += blob[..., None] * col
    return np.clip(out, 0, 255).astype(np.uint8)


def boxes(rng):
    n = rng.randint(1, 7)
    out = []
    for _ in range(n):
        w, h = rng.uniform(0.1, 0.5, 2)
        x0, y0 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
        out.append([rng.randint(0, 20), x0, y0, x0 + w, y0 + h])
    return np.asarray(out, np.float32)


def digest(data, labels):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(data, np.float32).tobytes())
    h.update(np.ascontiguousarray(labels, np.float32).tobytes())
    return h.hexdigest()


def decode_sha(img):
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def write(out_dir):
    from mxnet_tpu import io as jio
    from mxnet_tpu import recordio as jrec

    rng = np.random.RandomState(SEED)
    for name, det in zip(NAMES, (False, True)):
        w = jrec.MXIndexedRecordIO(os.path.join(out_dir, name + ".idx"),
                                   os.path.join(out_dir, name + ".rec"), "w")
        for i in range(N):
            img = smooth_image(rng)
            label = jio.pack_det_label(boxes(rng)) if det else float(i % 10)
            w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, label, i, 0), img,
                                         quality=QUALITY))
        w.close()


def references(out_dir):
    from mxnet_tpu import image as ji
    from mxnet_tpu import io as jio
    from mxnet_tpu import recordio as jrec

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import io as tio

    ref = {}
    for name, key in zip(NAMES, ("decode_sha", "det_decode_sha")):
        src = jrec.RecordSource(os.path.join(out_dir, name + ".rec"))
        shas, shapes = [], []
        for i in range(len(src)):
            a = ji.imdecode(src.read(i)[1]).asnumpy()
            shas.append(decode_sha(a))
            shapes.append(a.shape)
        ref[key] = np.asarray(shas)
        ref[key.replace("sha", "shape")] = np.asarray(shapes, np.int32)
    rec = os.path.join(out_dir, NAMES[0] + ".rec")
    batches = {}
    for route, kw in (("native", {}), ("python", {"force_python": True})):
        np.random.seed(ITER_SEED)
        it = jio.ImageRecordIter(rec, **ITER_KW, **kw)
        if route == "native" and it._pipe is None:
            raise RuntimeError("the JAX package's native image pipeline did "
                               "not load (libjpeg.so.62 missing?)")
        b = it.next()
        batches[route] = (b.data[0].asnumpy(), b.label[0].asnumpy())
        ref["jax_%s_batch0" % route] = digest(*batches[route])
    np.random.seed(ITER_SEED)
    with mt.cpu():
        b = tio.ImageRecordIter(rec, force_python=True, **ITER_KW).next()
    got = (b.data[0].asnumpy(), b.label[0].asnumpy())
    ref["port_python_batch0"] = digest(*got)
    # the route a machine without libjpeg.so.62 takes
    lib, err = tio._im_lib, tio._im_error
    tio._im_lib, tio._im_error = None, "the library is taken away"
    try:
        np.random.seed(ITER_SEED)
        with mt.cpu():
            it = tio.ImageRecordIter(rec, **ITER_KW)
            assert it.route == "python"
            b = it.next()
    finally:
        tio._im_lib, tio._im_error = lib, err
    ref["port_fallback_batch0"] = digest(b.data[0].asnumpy(),
                                         b.label[0].asnumpy())
    ref["port_python_parted_share"] = np.float64(
        np.mean(got[0] != batches["python"][0]))
    ref["port_python_max_abs"] = np.float64(
        np.abs(got[0] - batches["python"][0]).max())
    ref["iter_seed"] = np.int64(ITER_SEED)
    return ref


def main(argv):
    out_dir = argv[0] if argv else os.path.join(REPO, "tests", "fixtures")
    sys.path.insert(0, REPO)
    os.makedirs(out_dir, exist_ok=True)
    write(out_dir)
    ref = references(out_dir)
    np.savez(os.path.join(out_dir, "torch_images_ref.npz"), **ref)
    total = sum(os.path.getsize(os.path.join(out_dir, f))
                for f in os.listdir(out_dir) if f.startswith("torch_images"))
    print("wrote %s: %d bytes; port Python route parts from the JAX one "
          "at %.3g of its values (max %.4g)" % (
              out_dir, total, ref["port_python_parted_share"],
              ref["port_python_max_abs"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
