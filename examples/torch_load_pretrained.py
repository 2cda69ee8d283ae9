"""Load external pretrained weights without a model store, on the PyTorch
port (the twin of ``examples/load_pretrained.py``).

The reference downloads zoo weights from its model store; here nothing is
downloaded: ``mxnet_tpu_torch`` CONVERTS checkpoints you already have:

  1. torchvision resnet/mobilenet checkpoints (.pth)  -> vision zoo models
  2. HuggingFace BERT checkpoints                     -> models.bert.BERTModel
  3. one-time conversion to a native .params file     -> plain load_parameters

Run:  python examples/torch_load_pretrained.py [/path/to/resnet18.pth]
(without a path it fabricates a torchvision-layout checkpoint with
tools/torch_resnet_ref.py, seeded, in a temporary directory).
"""
import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from mxnet_tpu_torch import nd  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import get_model  # noqa: E402


def fabricate_checkpoint(path, seed=0):
    """A torchvision-layout ResNet-18 checkpoint at ``path`` (random,
    seeded weights; tools/torch_resnet_ref.py)."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_resnet_ref as tref

    torch.manual_seed(seed)
    torch.save(tref.resnet18().state_dict(), path)
    return path


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {"logits" (the converted model's, numpy), "native_logits"
    (after the native .params round trip), "checkpoint"}."""
    args = parse(argv)
    ctx = context_from_device(resolve_device(args.device))
    with tempfile.TemporaryDirectory() as d, ctx:
        ckpt = args.checkpoint
        if ckpt is None:  # demo: fabricate a torchvision-layout checkpoint
            ckpt = fabricate_checkpoint(os.path.join(d, "resnet18_demo.pth"))
            print("no checkpoint given; wrote a demo torchvision-layout "
                  "checkpoint to %s" % ckpt)

        # 1. straight into a model (torchvision basic-block resnets map onto
        #    *_v1; bottleneck resnets onto *_v1b — the v1.5 stride layout)
        net = get_model("resnet18_v1", pretrained=ckpt, ctx=ctx)
        s = args.image_size
        x = nd.array(np.random.default_rng(0)
                     .normal(size=(1, 3, s, s)).astype(np.float32))
        logits = net(x).asnumpy()
        print("resnet18_v1 logits[0,:5] =", logits[0, :5])

        # 2. convert ONCE to a native file, then load natively forever
        native = os.path.join(d, "resnet18_native.params")
        net.save_parameters(native)
        net2 = get_model("resnet18_v1", pretrained=native, ctx=ctx)
        logits2 = net2(x).asnumpy()
        assert np.allclose(logits2, logits)
        print("native .params round-trip OK "
              "(or: python -m mxnet_tpu_torch.gluon.model_zoo.convert "
              "resnet18_v1 %s out.params)" % ckpt)
    return {"logits": logits, "native_logits": logits2,
            "checkpoint": args.checkpoint}


if __name__ == "__main__":
    main()
