"""C.12: ``initialize`` takes ``ctx=`` (a Context, a device, or a list of
one) beside ``device=``, and accepts ``verbose``; with neither,
``base.resolve_device`` takes the innermost ``with ctx:``, then
``test_utils.set_default_context``'s, then the card, and raises
``DeviceError`` when none is there. The call sites that default through
it (the servers, GPT's ``generate``, quantization's skeleton device)
follow. Parameters made by the deterministic initializers equal the JAX
package's, and carried-across ones give the JAX forward."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import test_utils
from mxnet_tpu_torch.base import DeviceError, resolve_device
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import nn
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401
from torch_port_helpers import keep_block_names  # noqa: F401

# block names made here do not shift the names later tests compare
pytestmark = pytest.mark.usefixtures("keep_block_names")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def default_ctx():
    """``set_default_context`` for the test, put back after it."""
    from mxnet_tpu_torch import context

    prev = context._default
    yield test_utils.set_default_context
    context._default = prev


def _net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(6, in_units=4, activation="relu"))
        net.add(pkg.gluon.nn.Dense(3, in_units=6))
    return net


def test_resolve_order(no_card, default_ctx):
    with pytest.raises(DeviceError):
        resolve_device()
    with mx.cpu():
        assert resolve_device() == torch.device("cpu")
    default_ctx(mx.cpu())
    assert resolve_device() == torch.device("cpu")
    # the innermost scope wins over the default: a card asked, none there
    with mx.gpu(0):
        with pytest.raises(DeviceError):
            resolve_device()
        with mx.cpu():
            assert resolve_device() == torch.device("cpu")


@pytest.mark.parametrize("form", ["ctx", "ctx_list", "ctx_str",
                                  "positional", "with", "default",
                                  "device"])
def test_initialize_forms(no_card, default_ctx, form):
    net = _net(mx)
    init = mx.init.Constant(0.25)
    if form == "ctx":
        net.initialize(init, ctx=mx.cpu(), verbose=True)
    elif form == "ctx_list":
        net.initialize(init, ctx=[mx.cpu()])
    elif form == "ctx_str":
        net.initialize(init, ctx="cpu")
    elif form == "positional":
        net.initialize(init, mx.cpu())
    elif form == "with":
        with mx.cpu():
            net.initialize(init)
    elif form == "default":
        default_ctx(mx.cpu())
        net.initialize(init)
    else:
        net.initialize(init, device="cpu")
    for p in net.collect_params().values():
        assert p.list_ctx() == [mx.cpu()]
        assert p.data().context == mx.cpu()


def test_initialize_refusals(no_card):
    net = _net(mx)
    with pytest.raises(DeviceError):
        net.initialize()
    with pytest.raises(ValueError):
        net.initialize(ctx=[mx.cpu(), mx.cpu(1)])
    with pytest.raises(DeviceError):  # ctx and device both resolved first
        net.initialize(ctx=mx.cpu(), device="cuda")


def test_force_reinit_and_parameter_dict(no_card):
    net = _net(mx)
    net.collect_params().initialize(mx.init.One(), ctx=mx.cpu())
    w = net[0].weight
    assert float(w.data().asnumpy().min()) == 1.0
    net.initialize(mx.init.Zero(), ctx=mx.cpu())  # kept: no force
    assert float(w.data().asnumpy().min()) == 1.0
    net.initialize(mx.init.Zero(), ctx=mx.cpu(), force_reinit=True)
    assert float(np.abs(w.data().asnumpy()).max()) == 0.0
    w.initialize(mx.init.One(), ctx=mx.cpu(), force_reinit=True)
    assert float(w.data().asnumpy().min()) == 1.0


@pytest.mark.parametrize("init", ["Constant", "Orthogonal"])
@pytest.mark.parametrize("form", ["ctx", "with"])
def test_deterministic_init_equals_jax(jax_trace_state, no_card, init, form):
    """A deterministic initializer gives the JAX package's values exactly,
    on either form; the forward then equals the JAX forward."""
    make = {"Constant": lambda pkg: pkg.init.Constant(0.3),
            "Orthogonal": lambda pkg: pkg.init.Orthogonal()}[init]
    jnet = _net(jmx)
    jnet.initialize(make(jmx))
    tnet = _net(mx)
    if form == "ctx":
        tnet.initialize(make(mx), ctx=mx.cpu())
    else:
        with mx.cpu():
            tnet.initialize(make(mx))
    jp = {p.name[len(jnet.prefix):]: np.asarray(p.data()._data)
          for p in jnet.collect_params().values()}
    tp = {p.name[len(tnet.prefix):]: p.data().asnumpy()
          for p in tnet.collect_params().values()}
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    x = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).numpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_carried_parameters_forward_like_jax(jax_trace_state, no_card):
    """Xavier draws differ (Philox against threefry): the JAX values
    carried across give the JAX forward, on a net made under ``with
    mx.cpu():``."""
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier())
    with mx.cpu():
        tnet = _net(mx)
        tnet.initialize(mx.init.Xavier())
        from_jax_params(tnet, jax_params(jnet))
        x = mx.nd.array(np.random.RandomState(4).randn(5, 4)
                        .astype(np.float32))
    assert x.context == mx.cpu()
    np.testing.assert_allclose(tnet(x).asnumpy(),
                               jnet(jmx.nd.array(x.asnumpy())).asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_entry_points_follow_the_context(no_card):
    """The servers, GPT's generate and quantization's skeleton device take
    the ``with ctx:`` when given no device."""
    from mxnet_tpu_torch import quantization
    from mxnet_tpu_torch.models.gpt import gpt_nano
    from mxnet_tpu_torch.serve import GenerativeServer, ModelServer

    with mx.cpu():
        net = _net(mx)
        net.initialize()
        srv = ModelServer(net, [((4,), "float32")], buckets=(1,))
        assert srv.devices == [torch.device("cpu")]
        srv.stop()
        gpt = gpt_nano()
        gpt.initialize()
        out = gpt.generate([[1, 2, 3]], max_new_tokens=2)
        assert tuple(out.shape) == (1, 5)
        gen = GenerativeServer(gpt, slots=1)
        assert gen.device == torch.device("cpu")
        gen.stop()
        assert quantization._param_device(nn.Dense(3)) == torch.device("cpu")
