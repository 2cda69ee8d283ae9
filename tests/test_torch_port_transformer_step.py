"""A training step of the port's Transformer NMT model against the JAX
package's, on the small model of ``test_torch_port_transformer.py``
with a ``src_valid`` mask: the mean of ``softmax_xent_rows`` over the
logits (loss within 1e-5), each gradient within 1e-4 relative L2 plus
1e-6 absolute, the ``pos_enc`` constant without a gradient and
untouched by an Adam step."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import Constant
from mxnet_tpu_torch.ops import F
from test_torch_port_transformer import _close, _jnd, _np, pair  # noqa: F401
from torch_port_helpers import jax_params, jax_trace_state_module  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def test_train_step_matches_jax(pair):
    jm, tm, src, tgt = pair
    lab = np.random.RandomState(1).randint(4, 60, tgt.shape).astype(np.int32)
    v = np.array([9, 5, 2], np.int32)
    pos_before = tm.pos_enc._tensor().clone()
    with jag.record():
        jl = jmx.nd.mean(jmx.nd.softmax_xent_rows(
            jm(_jnd(src), _jnd(tgt), _jnd(v)), _jnd(lab)))
    jl.backward()
    trainer = gluon.Trainer(tm.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    with autograd.record():
        tl = F.softmax_xent_rows(tm(torch.from_numpy(src),
                                    torch.from_numpy(tgt),
                                    torch.from_numpy(v)),
                                 torch.from_numpy(lab)).mean()
    autograd.backward(tl)
    _close(tl, jl, 1e-5, "loss")
    tparams = tm.collect_params()
    for name, p in jm.collect_params().items():
        tp = tparams[tm.prefix + name[len(jm.prefix):]]
        if p.grad_req == "null":
            assert isinstance(tp, Constant) and tp.grad() is None
            continue
        # the key biases' gradients are 0 up to rounding (a softmax does
        # not move under a shift of its logits): 1e-6 absolute for them
        g, j = _np(tp.grad()), _np(p.grad())
        err = np.linalg.norm(g - j)
        assert err <= 1e-4 * np.linalg.norm(j) + 1e-6, (name, err)
    trainer.step(1)
    assert torch.equal(tm.pos_enc._tensor(), pos_before)
    assert tm.pos_enc not in trainer._params
    # put the weights back for the other tests
    from_jax_params(tm, jax_params(jm))
