#!/usr/bin/env python
"""PTB LSTM language model on the PyTorch port (the twin of
``examples/train_ptb_lm.py``; bench config #3, mirrors the reference's
example/rnn word-lm). A synthetic zipf stream unless ``--corpus`` names a
PTB text file; the loss takes the softmax-xent kernels on a card.

    python examples/torch_train_ptb_lm.py [--max-batches 50] [--device cpu]
"""
import argparse
import collections
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon, nd  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402
from mxnet_tpu_torch.models.lstm_lm import RNNModel  # noqa: E402

CORPUS = os.path.join(REPO, "_work", "datasets", "ptb", "ptb.train.txt")


def load_corpus(path=CORPUS, vocab_size=10000, synthetic_tokens=100000):
    path = os.path.expanduser(path)
    if os.path.exists(path):
        words = open(path).read().replace("\n", " <eos> ").split()
        vocab = {w: i for i, (w, _) in enumerate(
            sorted(collections.Counter(words).items(),
                   key=lambda kv: -kv[1])[:vocab_size])}
        data = np.array([vocab.get(w, 0) for w in words], np.int32)
        return data, len(vocab)
    rng = np.random.RandomState(0)
    # synthetic markov-ish stream so the model has learnable structure
    data = rng.zipf(1.5, synthetic_tokens).clip(0, vocab_size - 1).astype(np.int32)
    return data, vocab_size


def batchify(data, batch_size):
    n = len(data) // batch_size
    return data[:n * batch_size].reshape(batch_size, n).T  # (T, N)


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--bptt", type=int, default=35)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--num-hidden", type=int, default=200)
    ap.add_argument("--max-batches", type=int, default=50)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--corpus", default=CORPUS)
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, weights=None):
    """Returns {"losses", "perplexity", "seconds"}; ``weights`` ({name:
    array}) replace the initial parameters (``convert.carry_params``)."""
    args = parse(argv)
    corpus, vocab_size = load_corpus(args.corpus)
    data = batchify(corpus, args.batch_size)
    with context_from_device(resolve_device(args.device)):
        mx.random.seed(0)
        model = RNNModel("lstm", vocab_size=vocab_size,
                         num_embed=args.num_hidden,
                         num_hidden=args.num_hidden, num_layers=2,
                         dropout=args.dropout)
        model.initialize(mx.init.Xavier())
        if weights is not None:
            from mxnet_tpu_torch.convert import carry_params

            carry_params(model, weights)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": args.lr})
        ppl = mx.metric.Perplexity()
        losses = []
        t0 = time.perf_counter()
        for epoch in range(args.epochs):
            states = model.begin_state(args.batch_size)
            ppl.reset()
            nb = 0
            for i in range(0, data.shape[0] - 1 - args.bptt, args.bptt):
                x = nd.array(data[i:i + args.bptt], dtype="int32")
                y = nd.array(data[i + 1:i + 1 + args.bptt].astype(np.float32))
                states = [s.detach() for s in states]
                with autograd.record():
                    logits, states = model(x, states)
                    L = loss_fn(logits.reshape(-1, vocab_size),
                                y.reshape(-1)).mean()
                L.backward()
                gluon.utils.clip_global_norm(
                    [p.grad() for p in model.collect_params().values()
                     if p.grad_req != "null" and p.grad() is not None], 0.25)
                trainer.step(1)
                losses.append(float(L.asscalar()))
                sm = nd.softmax(logits.reshape(-1, vocab_size))
                ppl.update(y.reshape(-1), sm)
                nb += 1
                if nb >= args.max_batches:
                    break
            print("epoch %d %s=%.2f" % (epoch, *ppl.get()))
    return {"losses": losses, "perplexity": ppl.get()[1],
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
