"""Vision model zoo (ref: python/mxnet/gluon/model_zoo/vision/__init__.py;
the JAX package's ``mxnet_tpu/gluon/model_zoo/vision/__init__.py``)."""
from .resnet import (ResNetV1, ResNetV2, resnet18_v1, resnet34_v1,  # noqa: F401
                     resnet50_v1, resnet101_v1, resnet152_v1, resnet18_v2,
                     resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2,
                     resnet18_v1b, resnet34_v1b, resnet50_v1b, resnet101_v1b,
                     resnet152_v1b, get_resnet)
from . import alexnet, densenet, inception, mobilenet, resnet  # noqa: F401
from . import squeezenet, vgg  # noqa: F401

_models = {
    "resnet18_v1": resnet.resnet18_v1, "resnet34_v1": resnet.resnet34_v1,
    "resnet50_v1": resnet.resnet50_v1, "resnet101_v1": resnet.resnet101_v1,
    "resnet152_v1": resnet.resnet152_v1,
    "resnet18_v2": resnet.resnet18_v2, "resnet34_v2": resnet.resnet34_v2,
    "resnet50_v2": resnet.resnet50_v2, "resnet101_v2": resnet.resnet101_v2,
    "resnet152_v2": resnet.resnet152_v2,
    "resnet18_v1b": resnet.resnet18_v1b, "resnet34_v1b": resnet.resnet34_v1b,
    "resnet50_v1b": resnet.resnet50_v1b,
    "resnet101_v1b": resnet.resnet101_v1b,
    "resnet152_v1b": resnet.resnet152_v1b,
    "vgg11": vgg.vgg11, "vgg13": vgg.vgg13, "vgg16": vgg.vgg16,
    "vgg19": vgg.vgg19, "vgg11_bn": vgg.vgg11_bn, "vgg13_bn": vgg.vgg13_bn,
    "vgg16_bn": vgg.vgg16_bn, "vgg19_bn": vgg.vgg19_bn,
    "alexnet": alexnet.alexnet,
    "mobilenet1.0": mobilenet.mobilenet1_0,
    "mobilenet0.75": mobilenet.mobilenet0_75,
    "mobilenet0.5": mobilenet.mobilenet0_5,
    "mobilenet0.25": mobilenet.mobilenet0_25,
    "mobilenet_v2_tv": mobilenet.mobilenet_v2_tv,
    "mobilenetv2_1.0": mobilenet.mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet.mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet.mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet.mobilenet_v2_0_25,
    "squeezenet1.0": squeezenet.squeezenet1_0,
    "squeezenet1.1": squeezenet.squeezenet1_1,
    "densenet121": densenet.densenet121, "densenet161": densenet.densenet161,
    "densenet169": densenet.densenet169, "densenet201": densenet.densenet201,
    "inceptionv3": inception.inception_v3,
}


def get_model(name, **kwargs):
    """(ref: model_zoo/vision/__init__.py:get_model) The network ``name``
    of the registry, built with ``kwargs`` (``classes`` and the family's
    own). ``pretrained=<path>`` loads a native parameter file or converts
    a torchvision checkpoint (``gluon.model_zoo.convert``) on ``ctx``
    (default: the current CUDA device); ``pretrained=True`` raises: no
    model store is reachable."""
    from ..convert import build_with_pretrained

    pretrained = kwargs.pop("pretrained", False)
    ctx = kwargs.pop("ctx", None)
    if name.lower() not in _models:
        raise ValueError("model %s not found; available: %s"
                         % (name, sorted(_models)))
    return build_with_pretrained(_models[name.lower()], name.lower(),
                                 pretrained, ctx=ctx, **kwargs)
