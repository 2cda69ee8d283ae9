"""Fine-tune BERT-base for sentence-pair classification on the PyTorch
port (the twin of ``examples/finetune_bert.py``).

The GluonNLP finetune_classifier.py workflow (ref: gluon-nlp
scripts/bert/finetune_classifier.py): ``BERTClassifier`` over the trunk,
``hybridize()`` (on a card the forward and the backward are each one CUDA
graph a signature), Adam, ``metric.Accuracy``. ``--dtype bfloat16`` (the
default) casts the model with ``amp.convert_hybrid_block``, the AMP bf16
compute the JAX example's docstring names; at ``--seq`` 256 or more its
attention takes the flash kernels. ``--dtype float32`` runs the JAX
example's own fp32 step.

Runs on synthetic data, so it works out of the box, on the card (or on the
CPU with ``--device cpu``):
    python examples/torch_finetune_bert.py [--steps 30] [--tiny]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import amp, autograd, gluon, nd  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402
from mxnet_tpu_torch.models.bert import BERTClassifier, BERTModel  # noqa: E402


def synthetic_batch(rng, batch, seq, vocab):
    tok = rng.integers(0, vocab, (batch, seq))
    # "label = whether token 7 appears in the first half" — a learnable
    # synthetic signal (random labels would only overfit)
    y = (tok[:, : seq // 2] == 7).any(-1).astype(np.float32)
    tt = np.zeros((batch, seq), np.int64)
    vl = np.full((batch,), seq, np.float32)
    return (nd.array(tok.astype(np.float32)), nd.array(tt.astype(np.float32)),
            nd.array(vl), nd.array(y))


def build(args):
    """The classifier, initialized on the current context (seeded)."""
    vocab = 1000 if args.tiny else 30522
    if args.tiny:
        bert = BERTModel(vocab_size=vocab, units=128, hidden_size=512,
                         num_layers=2, num_heads=2, max_length=args.seq,
                         dropout=args.dropout, use_decoder=False,
                         use_classifier=False)
    else:
        from mxnet_tpu_torch.models.bert import bert_base

        bert = bert_base(vocab_size=vocab, max_length=args.seq,
                         dropout=args.dropout, use_decoder=False,
                         use_classifier=False)
    net = BERTClassifier(bert, num_classes=2, dropout=args.dropout)
    net.initialize()
    return net, vocab


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer 128-wide trunk (CPU-friendly smoke)")
    ap.add_argument("--pretrained", default=None, metavar="CKPT",
                    help="HF BertModel checkpoint (.pth/.bin torch state "
                         "dict) transplanted into the trunk before "
                         "fine-tuning (gluon.model_zoo.convert)")
    return ap.parse_args(argv)


def main(argv=None, weights=None):
    """Returns {"losses", "accuracy", "seconds", "net"}. ``weights``
    ({name: array}, e.g. a JAX model's) replace the initial parameters
    (``convert.carry_params``)."""
    args = parse(argv)
    with context_from_device(resolve_device(args.device)):
        mx.random.seed(0)
        net, vocab = build(args)
        if args.pretrained or weights is not None:
            # warm the deferred shapes with one forward first
            tok, tt, vl, _ = synthetic_batch(np.random.default_rng(0), 2,
                                             args.seq, vocab)
            net(tok, tt, vl)
        if args.pretrained:
            from mxnet_tpu_torch.gluon.model_zoo.convert import (
                load_torch_state, transplant_hf_bert)

            transplant_hf_bert(net.bert, load_torch_state(args.pretrained))
            print("transplanted pretrained trunk from %s" % args.pretrained)
        if weights is not None:
            from mxnet_tpu_torch.convert import carry_params

            carry_params(net, weights)
        if args.dtype != "float32":
            amp.convert_hybrid_block(net, args.dtype)
        net.hybridize()

        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": args.lr})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        metric = mx.metric.Accuracy()

        rng = np.random.default_rng(0)
        losses = []
        t0 = time.perf_counter()
        for step in range(1, args.steps + 1):
            tok, tt, vl, y = synthetic_batch(rng, args.batch, args.seq, vocab)
            with autograd.record():
                logits = net(tok, tt, vl)
                loss = loss_fn(logits, y)
            loss.backward()
            trainer.step(args.batch)
            metric.update(y, logits)
            losses.append(float(loss.asnumpy().astype(np.float64).mean()))
            if step % 10 == 0 or step == args.steps:
                name, acc = metric.get()
                print("step %3d  loss %.4f  %s %.3f  (%.2f s)"
                      % (step, losses[-1], name, acc,
                         time.perf_counter() - t0))
        name, acc = metric.get()
        print("final %s: %.3f" % (name, acc))
    return {"losses": losses, "accuracy": acc,
            "seconds": time.perf_counter() - t0, "net": net}


if __name__ == "__main__":
    main()
