#!/usr/bin/env python
"""im2rec for the PyTorch port (the twin of ``tools/im2rec.py``; ref:
incubator-mxnet tools/im2rec.py): pack an image folder or .lst file into
RecordIO with the port's ``recordio.pack_img`` and ``image.imresize``.
Everything runs on the host; no card is needed.

Usage:
  python tools/torch_im2rec.py <prefix> <root> [--list] [--recursive]

--list generates <prefix>.lst (index \\t label \\t relpath); without --list,
reads <prefix>.lst and writes <prefix>.rec + <prefix>.idx. The files are
the JAX package's (a .lst byte for byte; records equal at --resize 0).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_list(prefix, root, recursive=False, exts=(".jpg", ".jpeg", ".png")):
    entries = []
    classes = {}
    if recursive:
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = classes.setdefault(folder, len(classes))
            for f in sorted(os.listdir(path)):
                if f.lower().endswith(exts):
                    entries.append((os.path.join(folder, f), label))
    else:
        for f in sorted(os.listdir(root)):
            if f.lower().endswith(exts):
                entries.append((f, 0))
    with open(prefix + ".lst", "w") as out:
        for i, (rel, label) in enumerate(entries):
            out.write("%d\t%f\t%s\n" % (i, label, rel))
    return len(entries)


def make_record(prefix, root, quality=95, resize=0):
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image import imread_np, imresize_np

    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    n = 0
    try:
        with open(prefix + ".lst") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) < 3:
                    continue
                idx, label, rel = int(parts[0]), float(parts[1]), parts[2]
                img = imread_np(os.path.join(root, rel))
                if resize:
                    img = imresize_np(img, resize, resize)
                header = recordio.IRHeader(0, label, idx, 0)
                rec.write_idx(idx, recordio.pack_img(header, img,
                                                     quality=quality))
                n += 1
    finally:
        rec.close()
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("prefix")
    ap.add_argument("root")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--recursive", action="store_true")
    ap.add_argument("--resize", type=int, default=0)
    ap.add_argument("--quality", type=int, default=95)
    args = ap.parse_args(argv)
    if args.list:
        n = make_list(args.prefix, args.root, args.recursive)
        print("wrote %d entries to %s.lst" % (n, args.prefix))
    else:
        n = make_record(args.prefix, args.root, args.quality, args.resize)
        print("packed %d records into %s.rec" % (n, args.prefix))
    return {"entries" if args.list else "records": n}


if __name__ == "__main__":
    main()
