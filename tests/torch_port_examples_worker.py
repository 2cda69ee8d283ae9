"""One rank of ``tests/test_torch_port_examples.py``'s multi-rank twins
(gloo).

    python tests/torch_port_examples_worker.py RANK WORLD WORKDIR

As ``tests/torch_port_dist_worker.py`` (whose ``main`` it runs): joins a
gloo group of WORLD ranks through a file store in WORKDIR, reads
WORKDIR/inputs.npz, runs the twins of ``examples/train_long_context.py``
(ring and Ulysses) and ``examples/train_bert_distributed.py`` in that
group from the JAX examples' initial weights, and writes
WORKDIR/rank<RANK>.npz.
"""
import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_dist_worker import main as run_cases  # noqa: E402


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        "_twin_" + name, os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lc_params(inp):
    layers = int(inp["lc_layers"])
    return {"embed": inp["lc_embed"], "unembed": inp["lc_unembed"],
            "layers": [{k: inp["lc_l%d_%s" % (i, k)]
                        for k in ("qkv", "proj", "up", "down")}
                       for i in range(layers)]}


def _long_context(strategy):
    def case(inp, out, rank, world):
        r = _twin("torch_train_long_context").main(
            ["--device", "cpu", "--sp-strategy", strategy, "--steps", "2",
             "--seq", str(int(inp["lc_seq"])), "--heads",
             str(int(inp["lc_heads"])), "--width", str(int(inp["lc_d"]))],
            params=_lc_params(inp))
        out["losses"] = np.array(r["losses"])
        out["world"] = np.array(r["world"])
    return case


def case_bert(inp, out, rank, world):
    weights = {k[len("bd/"):]: v for k, v in inp.items()
               if k.startswith("bd/")}
    r = _twin("torch_train_bert_distributed").main(
        ["--device", "cpu", "--steps", "2", "--dropout", "0"],
        weights=weights)
    out["losses"] = np.array(r["losses"])
    out["mesh"] = np.array([r["mesh"]["dp"], r["mesh"]["tp"]])


CASES = [("lc_ring", _long_context("ring")),
         ("lc_ulysses", _long_context("ulysses")),
         ("bert", case_bert)]


if __name__ == "__main__":
    run_cases(sys.argv[1:], CASES)
