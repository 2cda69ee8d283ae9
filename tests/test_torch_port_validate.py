"""graphlint stage 2 in the port (``analysis.validate``): the JAX package's
planted blocks (a host read, a per-call counter in the math, a dead
parameter, an ``if`` on the data), written for each package, give the
same rule IDs, GL101-GL104, from ``check_hybridizable`` and from
``hybridize(validate=True)``, which raises at the first forward only;
clean blocks (a Dense chain, BERT-small with its MLM head) find nothing
and compute what they compute unvalidated."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import analysis as janalysis
from mxnet_tpu_torch import analysis
from torch_port_helpers import (SMALL_BERT, bert_inputs,  # noqa: F401
                                jax_trace_state)
from torch_port_helpers import keep_block_names  # noqa: F401

# block names made here do not shift the names later tests compare
pytestmark = pytest.mark.usefixtures("keep_block_names")


def _planted(pkg):
    """The four blocks, written for ``pkg`` (the JAX package's planted
    cases, its test_graphlint's; the port's the same in torch)."""
    gluon = pkg.gluon

    class Leaky(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * float(F.sum(x))

    class Retrace(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self._n = 0

        def hybrid_forward(self, F, x):
            self._n += 1
            return x * self._n

    class DeadParam(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.weight = self.params.get("weight", shape=(8,))

        def hybrid_forward(self, F, x, weight):
            return x * 2.0  # never touches its parameter

    class Branchy(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            if F.sum(x) > 0:
                return x
            return -x

    return {"GL101": Leaky, "GL102": Retrace, "GL103": DeadParam,
            "GL104": Branchy}


def _x(pkg):
    a = np.abs(np.random.RandomState(0).randn(2, 8)).astype(np.float32)
    if pkg is mx:
        return mx.nd.array(a, ctx=mx.cpu())
    return jmx.nd.array(a)


@pytest.mark.parametrize("case", sorted(_planted(mx)))
def test_planted_blocks_give_the_jax_ids(jax_trace_state, case):
    rule = case.split()[0]
    tblk, jblk = _planted(mx)[case](), _planted(jmx)[case]()
    tblk.initialize(ctx=mx.cpu())
    jblk.initialize()
    mine = {f.rule for f in analysis.check_hybridizable(tblk, _x(mx))}
    theirs = {f.rule for f in janalysis.check_hybridizable(jblk, _x(jmx))}
    assert rule in mine and rule in theirs, (mine, theirs)
    if rule == "GL103":
        found = analysis.check_hybridizable(tblk, _x(mx))
        assert any("weight" in f.msg for f in found if f.rule == "GL103")


def test_ndarray_host_copy_is_gl101():
    """``NDArray.asnumpy`` in a forward (the port's hybrid_forward takes
    tensors; a script wraps one to read it back) is a host read."""
    class HostCopy(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x + float(mx.nd.NDArray(x).asnumpy().sum())

    found = analysis.check_hybridizable(HostCopy(), _x(mx))
    assert [f.rule for f in found] == ["GL101"]
    assert ".asnumpy()" in found[0].msg and found[0].line > 0


@pytest.mark.parametrize("rule", ["GL101", "GL102", "GL104"])
def test_hybridize_validate_raises_at_first_forward(rule):
    blk = _planted(mx)[rule]()
    blk.initialize(ctx=mx.cpu())
    blk.hybridize(validate=True)
    with pytest.raises(analysis.GraphlintError) as ei:
        blk(_x(mx))
    assert rule in {f.rule for f in ei.value.findings}
    assert "validate=True" in str(ei.value)
    blk(_x(mx))  # checked once: the next call runs
    blk.hybridize()  # no validate: never checked
    blk(_x(mx))


def test_clean_blocks_pass_and_compute_as_unvalidated():
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(16, in_units=8, activation="relu"))
            net.add(mx.gluon.nn.Dense(4, in_units=16))
        net.initialize()
        x = _x(mx)
        assert analysis.check_hybridizable(net, x) == []
        want = net(x).asnumpy()
        net.hybridize(validate=True)
        np.testing.assert_array_equal(net(x).asnumpy(), want)
        assert net.hybrid_stats()["forward_captures"] == 1


def test_bert_small_with_its_mlm_head_is_clean():
    from mxnet_tpu_torch.models.bert import BERTModel

    model = BERTModel(**SMALL_BERT)
    model.initialize(ctx=mx.cpu())
    model.cast("bfloat16")
    tok, tt, vl = bert_inputs(1, 3)
    mp = np.sort(np.random.RandomState(2).randint(0, 64, (3, 5)),
                 axis=1).astype(np.int32)
    ins = [torch.from_numpy(a) for a in (tok, tt, vl, mp)]
    assert analysis.check_hybridizable(model, *ins) == []
    # without the masked positions the MLM head's parameters reach no
    # output: GL103 names them
    dead = {f.msg.split("'")[1] for f in
            analysis.check_hybridizable(model, *ins[:3])
            if f.rule == "GL103"}
    assert dead and all("decoder" in n or "mlm" in n or "layernorm" in n
                        for n in dead), dead
