"""The port's vision model zoo against the JAX package's: ``get_model``
over the whole registry (every name builds, with the JAX model's
parameter names and declared shapes), each family's inference forward at
small sizes (fp32, within 1e-5 of the largest logit: sums in another
order; densenet and inception in ``test_torch_port_model_zoo_deep.py``),
the s2d stem option (the same parameter, under the same structural name,
and the same convolution), ``pretrained=True`` raising and
``pretrained=<path>`` loading a native file.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401
from torch_port_helpers import numpy_uniform
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

NAMES = sorted(vision._models)


def test_registry_is_the_jax_registry():
    import inspect

    src = inspect.getsource(jvision.get_model)
    for name in NAMES:
        assert '"%s"' % name in src, name
    assert len(NAMES) == src.count('": ')
    with pytest.raises(ValueError, match="not found"):
        vision.get_model("not_a_model")


@pytest.mark.parametrize("name", NAMES)
def test_every_model_has_the_jax_parameters(name):
    """Names (under each root prefix) and declared shapes, deferred
    dimensions included, before any forward."""
    j = jvision.get_model(name, classes=7)
    t = vision.get_model(name, classes=7)
    jp = {p.name[len(j.prefix):]: p.shape for p in
          j.collect_params().values()}
    tp = {p.name[len(t.prefix):]: p.shape for p in
          t.collect_params().values()}
    assert tp.keys() == jp.keys()
    for n in jp:
        assert tuple(tp[n]) == tuple(jp[n]), n


def family_forward_matches_jax(name, size):
    """Inference logits (batch 1, 10 classes): every convolution, pooling,
    BatchNorm (moving statistics), concatenation and the classifier."""
    x = np.random.RandomState(size).randn(1, 3, size, size).astype(
        np.float32)
    j = jvision.get_model(name, classes=10)
    j.initialize(numpy_uniform())
    jy = np.asarray(j(mx.nd.array(x)).asnumpy())
    t = from_jax_params(vision.get_model(name, classes=10), jax_params(j))
    ty = t(torch.from_numpy(x)).detach().numpy()
    assert ty.shape == jy.shape == (1, 10)
    assert np.abs(ty - jy).max() <= 1e-5 * max(np.abs(jy).max(), 1.0)


@pytest.mark.parametrize("name,size", [
    ("vgg11_bn", 32), ("alexnet", 224), ("mobilenet0.25", 32),
    ("mobilenetv2_1.0", 32), ("mobilenet_v2_tv", 32), ("squeezenet1.1", 96),
])
def test_family_forward_matches_jax(jax_trace_state, name, size):  # noqa: F811
    family_forward_matches_jax(name, size)


def test_s2d_stem_is_the_plain_convolution(jax_trace_state,  # noqa: F811
                                           tmp_path):
    """``stem_s2d=True`` keeps the plain stem's parameter (name and shape)
    and computes the same 7x7 stride-2 convolution (the JAX package's
    space-to-depth rewrite re-lays the TPU's input lanes; the port has no
    use for it), so one parameter file serves both, and both equal the
    JAX s2d model's forward."""
    x = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    j = jvision.get_resnet(1, 18, classes=7, stem_s2d=True)
    j.initialize(numpy_uniform())
    jy = np.asarray(j(mx.nd.array(x)).asnumpy())
    s2d = from_jax_params(vision.get_resnet(1, 18, classes=7, stem_s2d=True),
                          jax_params(j))
    assert s2d.features[0].weight.shape == (64, 3, 7, 7)
    path = str(tmp_path / "s2d.params")
    s2d.save_parameters(path)
    plain = vision.get_resnet(1, 18, classes=7)
    plain.load_parameters(path, ctx="cpu")
    for t in (s2d, plain):
        ty = t(torch.from_numpy(x)).detach().numpy()
        assert np.abs(ty - jy).max() <= 1e-4 * max(np.abs(jy).max(), 1.0)


def test_pretrained_true_raises_and_a_path_loads(jax_trace_state,  # noqa: F811
                                                 tmp_path):
    """``pretrained=True`` raises before anything is built; a JAX model's
    ``save_parameters`` file loads through ``pretrained=<path>`` (on the
    CPU with ``ctx="cpu"``, else on the card: without one it raises) and
    gives the JAX model's logits; a torch checkpoint is refused until its
    converter is ported."""
    from mxnet_tpu_torch.base import DeviceError

    with pytest.raises(ValueError, match="model store"):
        vision.get_model("resnet18_v1", pretrained=True)
    with pytest.raises(ValueError, match="model store"):
        vision.resnet18_v1(pretrained=True)
    x = np.random.RandomState(3).randn(1, 3, 32, 32).astype(np.float32)
    j = jvision.get_model("squeezenet1.1", classes=5)
    j.initialize(numpy_uniform())
    jy = np.asarray(j(mx.nd.array(x)).asnumpy())
    path = str(tmp_path / "sq.params")
    j.save_parameters(path)
    t = vision.get_model("squeezenet1.1", classes=5, pretrained=path,
                         ctx="cpu")
    ty = t(torch.from_numpy(x)).detach().numpy()
    assert np.abs(ty - jy).max() <= 1e-5 * max(np.abs(jy).max(), 1.0)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            vision.get_model("squeezenet1.1", classes=5, pretrained=path)
    # a torch checkpoint goes through the torchvision converter
    # (test_torch_port_convert.py): a missing one is a missing file
    with pytest.raises(FileNotFoundError):
        vision.get_model("resnet18_v1", pretrained=str(tmp_path / "r.pth"),
                         ctx="cpu")
