"""Pretrained weights for the vision zoo and the transformer models
(counterpart of ``mxnet_tpu/gluon/model_zoo/convert.py``).

No model store is reachable, so ``pretrained`` is a path on disk:

- a native parameter file (``.params``/``.npz``, either package's
  ``save_parameters``), loaded by structural name;
- a torchvision checkpoint (``.pth``/``.pt``/``.bin``), remapped onto the
  zoo's structural names by the family's converter: ``resnet18/34_v1``
  (basic blocks), ``resnet50/101/152_v1b`` (torchvision's stride on the
  3x3), ``vgg11/13/16/19[_bn]``, ``alexnet``, ``squeezenet1.0/1.1``,
  ``densenet121/161/169/201``, ``inceptionv3`` and ``mobilenet_v2_tv``;
- HuggingFace ``BertModel`` / ``GPT2Model`` tensors, transplanted onto
  ``models.bert.BERTModel`` / ``models.gpt.GPTModel`` with q, k and v fused
  into one projection (:func:`transplant_hf_bert`,
  :func:`transplant_hf_gpt2`).

The converters are numpy remappings: for the same checkpoint they give the
JAX package's converters' arrays bit for bit. ``pretrained=True`` raises.
``get_model(name, pretrained="x.pth")`` routes through
:func:`load_pretrained`; the CLI converts a checkpoint once into a native
``.params`` file:

    python -m mxnet_tpu_torch.gluon.model_zoo.convert resnet18_v1 r18.pth \
        out.params [--device cpu]
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ...base import resolve_device

__all__ = ["convert_torchvision_resnet", "convert_torchvision_generic",
           "convert_torchvision_densenet", "convert_torchvision_inception",
           "apply_converted", "load_pretrained", "transplant_hf_bert",
           "transplant_hf_gpt2", "load_torch_state", "converted_mapping"]

# torch BatchNorm attribute -> the zoo BatchNorm's parameter suffix
_BN = {"weight": "gamma", "bias": "beta",
       "running_mean": "running_mean", "running_var": "running_var"}


def _to_np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, dtype=np.float32)


def load_torch_state(path):
    """``torch.load`` a checkpoint (``weights_only``) and unwrap it to a
    flat name -> tensor dict: ``{"state_dict": ...}``/``{"model": ...}``
    nesting and ``module.`` prefixes removed, floating tensors in fp32."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(state, dict) and key in state \
                and isinstance(state[key], dict):
            state = state[key]
    if not isinstance(state, dict):
        return state
    if state and all(isinstance(k, str) and k.startswith("module.")
                     for k in state):
        state = {k[len("module."):]: v for k, v in state.items()}
    return {k: (v.float() if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v)
            for k, v in state.items()}


def convert_torchvision_resnet(state):
    """torchvision resnet state dict -> {structural name: array} of
    ``ResNetV1`` with ``BasicBlockV1`` (resnet18/34) or ``BottleneckV1b``
    (resnet50/101/152). Convolution and fc layouts already agree."""
    bottleneck = "layer1.0.conv3.weight" in state
    conv_pos = {1: 0, 2: 3, 3: 6} if bottleneck else {1: 0, 2: 3}
    bn_pos = {1: 1, 2: 4, 3: 7} if bottleneck else {1: 1, 2: 4}
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue  # the zoo's BatchNorm keeps no step counter
        m = re.match(r"^layer(\d+)\.(\d+)\.(.+)$", k)
        if m:
            stage, idx, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            base = "features.%d.%d." % (3 + stage, idx)
            cm = re.match(r"^conv(\d)\.weight$", rest)
            bm = re.match(r"^bn(\d)\.(\w+)$", rest)
            dm = re.match(r"^downsample\.(\d)\.(\w+)$", rest)
            if cm:
                out[base + "body.%d.weight"
                    % conv_pos[int(cm.group(1))]] = _to_np(v)
            elif bm:
                out[base + "body.%d.%s"
                    % (bn_pos[int(bm.group(1))], _BN[bm.group(2)])] = \
                    _to_np(v)
            elif dm:
                ds_idx, attr = int(dm.group(1)), dm.group(2)
                name = "weight" if ds_idx == 0 else _BN[attr]
                out[base + "downsample.%d.%s" % (ds_idx, name)] = _to_np(v)
            else:
                raise KeyError("unrecognized torchvision resnet key %r" % k)
        elif k == "conv1.weight":
            out["features.0.weight"] = _to_np(v)
        elif k.startswith("bn1."):
            out["features.1.%s" % _BN[k.split(".", 1)[1]]] = _to_np(v)
        elif k in ("fc.weight", "fc.bias"):
            out["output.%s" % k.split(".")[1]] = _to_np(v)
        else:
            raise KeyError("unrecognized torchvision resnet key %r" % k)
    return out


def convert_torchvision_generic(state, rename=None):
    """torchvision state dict -> structural names, for models whose module
    paths mirror the zoo's up to a renamed prefix (``mobilenet_v2_tv``,
    vgg, alexnet, squeezenet): a BatchNorm (a module with a
    ``running_mean``) renames its tensors, everything else passes through;
    ``rename`` maps leading module paths, one rename a key."""
    bn = {k[: -len(".running_mean")]
          for k in state if k.endswith(".running_mean")}
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        orig_pre, _, attr = k.rpartition(".")
        path = k
        for old, new in (rename or {}).items():
            if path == old or path.startswith(old + "."):
                path = new + path[len(old):]
                break
        pre = path.rpartition(".")[0]
        name = _BN[attr] if orig_pre in bn and attr in _BN else attr
        out[pre + "." + name] = _to_np(v)
    return out


def convert_torchvision_densenet(state):
    """torchvision densenet state dict -> the zoo's positional DenseNet:
    ``denseblock{i}.denselayer{j}.{norm1,conv1,norm2,conv2}`` land in
    ``features.{4+2(i-1)}.{j-1}.body.{0,2,3,5}``, the transitions at the
    odd indices between blocks, stem and head at fixed positions."""
    sub = {"norm1": "body.0", "conv1": "body.2",
           "norm2": "body.3", "conv2": "body.5"}
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        m = re.match(
            r"^features\.denseblock(\d+)\.denselayer(\d+)\.(\w+)\.(\w+)$", k)
        if m:
            bi, lj, mod, attr = (int(m.group(1)), int(m.group(2)),
                                 m.group(3), m.group(4))
            name = _BN[attr] if mod.startswith("norm") else attr
            out["features.%d.%d.%s.%s"
                % (4 + 2 * (bi - 1), lj - 1, sub[mod], name)] = _to_np(v)
            continue
        m = re.match(r"^features\.transition(\d+)\.(norm|conv)\.(\w+)$", k)
        if m:
            ti, mod, attr = int(m.group(1)), m.group(2), m.group(3)
            pos = 0 if mod == "norm" else 2
            name = _BN[attr] if mod == "norm" else attr
            out["features.%d.%d.%s" % (5 + 2 * (ti - 1), pos, name)] = \
                _to_np(v)
            continue
        if k == "features.conv0.weight":
            out["features.0.weight"] = _to_np(v)
        elif k.startswith("features.norm0."):
            out["features.1.%s" % _BN[k.rsplit(".", 1)[1]]] = _to_np(v)
        elif k.startswith("features.norm5."):
            out["features.11.%s" % _BN[k.rsplit(".", 1)[1]]] = _to_np(v)
        elif k in ("classifier.weight", "classifier.bias"):
            out["output.%s" % k.split(".")[1]] = _to_np(v)
        else:
            raise KeyError("unrecognized torchvision densenet key %r" % k)
    return out


def _inception_prefix_map():
    """torchvision InceptionV3 module paths -> the zoo's positional paths
    (the same graph: torchvision names its blocks, the zoo nests them)."""
    m = {"Conv2d_1a_3x3": "features.0", "Conv2d_2a_3x3": "features.1",
         "Conv2d_2b_3x3": "features.2", "Conv2d_3b_1x1": "features.4",
         "Conv2d_4a_3x3": "features.5"}
    for i, name in enumerate(("Mixed_5b", "Mixed_5c", "Mixed_5d")):
        our = "features.%d" % (7 + i)
        m[name + ".branch1x1"] = our + ".branch0"
        m[name + ".branch5x5_1"] = our + ".branch1.0"
        m[name + ".branch5x5_2"] = our + ".branch1.1"
        for j in range(1, 4):
            m[name + ".branch3x3dbl_%d" % j] = our + ".branch2.%d" % (j - 1)
        m[name + ".branch_pool"] = our + ".branch3.1"
    m["Mixed_6a.branch3x3"] = "features.10.branch0"
    for j in range(1, 4):
        m["Mixed_6a.branch3x3dbl_%d" % j] = "features.10.branch1.%d" % (j - 1)
    for i, name in enumerate(("Mixed_6b", "Mixed_6c", "Mixed_6d",
                              "Mixed_6e")):
        our = "features.%d" % (11 + i)
        m[name + ".branch1x1"] = our + ".branch0"
        for j in range(1, 4):
            m[name + ".branch7x7_%d" % j] = our + ".branch1.%d" % (j - 1)
        for j in range(1, 6):
            m[name + ".branch7x7dbl_%d" % j] = our + ".branch2.%d" % (j - 1)
        m[name + ".branch_pool"] = our + ".branch3.1"
    m["Mixed_7a.branch3x3_1"] = "features.15.branch0.0"
    m["Mixed_7a.branch3x3_2"] = "features.15.branch0.1"
    for j in range(1, 5):
        m["Mixed_7a.branch7x7x3_%d" % j] = "features.15.branch1.%d" % (j - 1)
    for i, name in enumerate(("Mixed_7b", "Mixed_7c")):
        our = "features.%d" % (16 + i)
        m[name + ".branch1x1"] = our + ".branch0"
        m[name + ".branch3x3_1"] = our + ".branch1.pre"
        m[name + ".branch3x3_2a"] = our + ".branch1.a"
        m[name + ".branch3x3_2b"] = our + ".branch1.b"
        m[name + ".branch3x3dbl_1"] = our + ".branch2.p1"
        m[name + ".branch3x3dbl_2"] = our + ".branch2.p2"
        m[name + ".branch3x3dbl_3a"] = our + ".branch2.a"
        m[name + ".branch3x3dbl_3b"] = our + ".branch2.b"
        m[name + ".branch_pool"] = our + ".branch3.1"
    return m


def convert_torchvision_inception(state):
    """torchvision inception_v3 state dict -> the zoo's Inception3; the
    training-time ``AuxLogits`` head is dropped."""
    m = _inception_prefix_map()
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked") or k.startswith("AuxLogits."):
            continue
        if k in ("fc.weight", "fc.bias"):
            out["output.%s" % k.split(".")[1]] = _to_np(v)
            continue
        if k.endswith(".conv.weight"):
            blk, suffix = k[: -len(".conv.weight")], ".0.weight"
        elif ".bn." in k:
            blk, attr = k.rsplit(".bn.", 1)
            suffix = ".1.%s" % _BN[attr]
        else:
            blk = None
        if blk is None or blk not in m:
            raise KeyError("unrecognized torchvision inception key %r" % k)
        out[m[blk] + suffix] = _to_np(v)
    return out


def _put(p, arr, ctx, device):
    """Set parameter ``p`` from ``arr``; a parameter that holds no value
    yet goes to ``ctx`` (resolved once, into ``device[0]``)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    if p._data is None:
        if device[0] is None:
            device[0] = resolve_device(ctx)
        t = t.to(device[0])
    p.set_data(t)


def apply_converted(net, mapping, strict=True, ctx=None):
    """Write {structural name: array} into ``net``'s parameters. Works
    before the first forward (a deferred parameter takes the array's shape,
    on ``ctx``, default the current CUDA device); an initialized one keeps
    its device and checks the shape. ``strict`` refuses a mapping that
    does not cover the network exactly."""
    params = net._collect_params_with_prefix()
    missing = sorted(set(params) - set(mapping))
    extra = sorted(set(mapping) - set(params))
    if strict and (missing or extra):
        raise KeyError(
            "converted checkpoint does not cover the network: missing=%s "
            "extra=%s" % (missing[:8], extra[:8]))
    device = [None]
    for name, arr in mapping.items():
        if name in params:
            _put(params[name], arr, ctx, device)
    return net


def transplant_hf_bert(model, state, ctx=None):
    """HuggingFace ``BertModel`` tensors -> ``models.bert.BERTModel``: the
    q, k and v rows concatenated into the fused qkv projection. ``state``
    maps HF names (optionally with the ``bert.`` prefix of the task heads)
    to tensors or arrays."""
    state = {k[len("bert."):] if k.startswith("bert.") else k: v
             for k, v in state.items()}
    device = [None]

    def get(name):
        return _to_np(state[name])

    def set_(p, arr):
        _put(p, arr, ctx, device)

    set_(model.word_embed.weight, get("embeddings.word_embeddings.weight"))
    set_(model.token_type_embed.weight,
         get("embeddings.token_type_embeddings.weight"))
    set_(model.encoder.position_weight,
         get("embeddings.position_embeddings.weight"))
    set_(model.encoder.ln.gamma, get("embeddings.LayerNorm.weight"))
    set_(model.encoder.ln.beta, get("embeddings.LayerNorm.bias"))
    for i, cell in enumerate(model.encoder.cells):
        pre = "encoder.layer.%d." % i
        set_(cell.attention.qkv.weight, np.concatenate(
            [get(pre + "attention.self.%s.weight" % n)
             for n in ("query", "key", "value")], axis=0))
        set_(cell.attention.qkv.bias, np.concatenate(
            [get(pre + "attention.self.%s.bias" % n)
             for n in ("query", "key", "value")], axis=0))
        set_(cell.attention.attn_out.weight,
             get(pre + "attention.output.dense.weight"))
        set_(cell.attention.attn_out.bias,
             get(pre + "attention.output.dense.bias"))
        set_(cell.ln1.gamma, get(pre + "attention.output.LayerNorm.weight"))
        set_(cell.ln1.beta, get(pre + "attention.output.LayerNorm.bias"))
        set_(cell.ffn.ffn_1.weight, get(pre + "intermediate.dense.weight"))
        set_(cell.ffn.ffn_1.bias, get(pre + "intermediate.dense.bias"))
        set_(cell.ffn.ffn_2.weight, get(pre + "output.dense.weight"))
        set_(cell.ffn.ffn_2.bias, get(pre + "output.dense.bias"))
        set_(cell.ln2.gamma, get(pre + "output.LayerNorm.weight"))
        set_(cell.ln2.beta, get(pre + "output.LayerNorm.bias"))
    if getattr(model, "_use_pooler", True) and hasattr(model, "pooler"):
        set_(model.pooler.weight, get("pooler.dense.weight"))
        set_(model.pooler.bias, get("pooler.dense.bias"))
    return model


def transplant_hf_gpt2(model, state, ctx=None):
    """HuggingFace ``GPT2Model``/``GPT2LMHeadModel`` tensors ->
    ``models.gpt.GPTModel``. HF's Conv1D stores (in, out): transposed into
    the Dense (out, in); ``c_attn``'s [q|k|v] columns are then the qkv
    rows. ``state`` maps HF names (optionally with the ``transformer.``
    prefix of the LM-head checkpoints) to tensors or arrays."""
    state = {k[len("transformer."):] if k.startswith("transformer.") else k:
             v for k, v in state.items()}
    device = [None]

    def get(name, transpose=False):
        v = _to_np(state[name])
        return v.T if transpose else v

    def set_(p, arr):
        _put(p, arr, ctx, device)

    set_(model.word_embed.weight, get("wte.weight"))
    set_(model.pos_embed.weight, get("wpe.weight"))
    for i, blk in enumerate(model.blocks):
        pre = "h.%d." % i
        set_(blk.ln1.gamma, get(pre + "ln_1.weight"))
        set_(blk.ln1.beta, get(pre + "ln_1.bias"))
        set_(blk.attn.qkv.weight, get(pre + "attn.c_attn.weight", True))
        set_(blk.attn.qkv.bias, get(pre + "attn.c_attn.bias"))
        set_(blk.attn.attn_out.weight, get(pre + "attn.c_proj.weight", True))
        set_(blk.attn.attn_out.bias, get(pre + "attn.c_proj.bias"))
        set_(blk.ln2.gamma, get(pre + "ln_2.weight"))
        set_(blk.ln2.beta, get(pre + "ln_2.bias"))
        set_(blk.ffn_1.weight, get(pre + "mlp.c_fc.weight", True))
        set_(blk.ffn_1.bias, get(pre + "mlp.c_fc.bias"))
        set_(blk.ffn_2.weight, get(pre + "mlp.c_proj.weight", True))
        set_(blk.ffn_2.bias, get(pre + "mlp.c_proj.bias"))
    set_(model.ln_f.gamma, get("ln_f.weight"))
    set_(model.ln_f.beta, get("ln_f.bias"))
    return model


def resolve_pretrained(pretrained):
    """Check a factory's ``pretrained`` before the network is built:
    ``True`` raises (no model store), a path passes, a false value gives
    None."""
    if pretrained is True:
        raise ValueError(
            "no model store is reachable; pass pretrained=<path> to a "
            "native .params file or a torch checkpoint (see "
            "gluon.model_zoo.convert)")
    return pretrained or None


def build_with_pretrained(factory, name, pretrained, ctx=None, **kwargs):
    """The one pretrained path of every zoo factory: check ``pretrained``,
    build ``factory(**kwargs)``, then load the file on ``ctx``."""
    path = resolve_pretrained(pretrained)
    net = factory(**kwargs)
    if path:
        load_pretrained(net, path, name, ctx)
    return net


_RESNET_NAME = re.compile(r"^resnet(\d+)_v(1b?|2)$")


def converted_mapping(net, state, name, path="checkpoint"):
    """The {structural name: array} that ``load_pretrained`` writes into
    ``net`` (the zoo model ``name``) for the torchvision state dict
    ``state``; raises for a checkpoint the model cannot take."""
    if name == "mobilenet_v2_tv":
        return convert_torchvision_generic(
            state, rename={"classifier.1": "output"})
    if re.match(r"^vgg(11|13|16|19)(_bn)?$", name):
        # conv/bn indices already align; only torchvision's split-off
        # classifier remaps onto the trailing Dense layers (its adaptive
        # pool is the identity at the 224 input these weights assume)
        from .. import nn
        dense_idx = [k for k, ch in net.features._children.items()
                     if isinstance(ch, nn.Dense)]
        rename = {"classifier.0": "features.%s" % dense_idx[0],
                  "classifier.3": "features.%s" % dense_idx[1],
                  "classifier.6": "output"}
        return convert_torchvision_generic(state, rename=rename)
    if re.match(r"^densenet(121|161|169|201)$", name):
        return convert_torchvision_densenet(state)
    if name == "inceptionv3":
        return convert_torchvision_inception(state)
    if name in ("squeezenet1.0", "squeezenet1.1"):
        # torchvision holds its ReLUs inline (shifting the Fire indices)
        # and names the expands expand1x1/expand3x3 (the zoo: expand1/3)
        idx = ({3: 2, 4: 3, 5: 4, 7: 6, 8: 7, 9: 8, 10: 9, 12: 11}
               if name.endswith("1.0")
               else {3: 2, 4: 3, 6: 5, 7: 6, 9: 8, 10: 9, 11: 10, 12: 11})
        rename = {"features.%d" % k: "features.%d" % v
                  for k, v in idx.items()}
        rename["classifier.1"] = "output.0"
        state = {k.replace(".expand1x1.", ".expand1.")
                  .replace(".expand3x3.", ".expand3."): v
                 for k, v in state.items()}
        return convert_torchvision_generic(state, rename=rename)
    if name == "alexnet":
        # the zoo's convolutions fuse their relu, shifting the indices
        rename = {"features.0": "features.0", "features.3": "features.2",
                  "features.6": "features.4", "features.8": "features.5",
                  "features.10": "features.6", "classifier.1": "features.9",
                  "classifier.4": "features.11", "classifier.6": "output"}
        return convert_torchvision_generic(state, rename=rename)
    m = _RESNET_NAME.match(name)
    if m:
        ver = m.group(2)
        bottleneck = "layer1.0.conv3.weight" in state
        if bottleneck and ver == "1":
            raise ValueError(
                "torchvision bottleneck resnets use the v1.5 (stride-on-3x3) "
                "layout; load %s into resnet%s_v1b, not _v1, or the stride "
                "placement silently changes the computation"
                % (path, m.group(1)))
        if ver == "2":
            raise ValueError("torchvision ships no v2 (pre-activation) "
                             "resnet checkpoints to convert")
        return convert_torchvision_resnet(state)
    raise ValueError(
        "no torch converter registered for model %r; supported: resnet*_v1 "
        "(basic blocks), resnet*_v1b (bottlenecks), vgg11/13/16/19[_bn], "
        "alexnet, squeezenet1.0/1.1, densenet121/161/169/201, inceptionv3, "
        "mobilenet_v2_tv, and transplant_hf_bert for BERT checkpoints"
        % name)


def load_pretrained(net, path, name, ctx=None):
    """Load ``path`` into ``net`` (the zoo model ``name``): a native
    ``.params``/``.npz`` file directly, a torch ``.pth``/``.pt``/``.bin``
    checkpoint through the family's converter. Parameters that hold no
    value yet go to ``ctx`` (default: the current CUDA device)."""
    p = str(path)
    if p.endswith((".params", ".npz")):
        net.load_parameters(p, ctx=ctx)
        return net
    if not p.endswith((".pth", ".pt", ".bin")):
        raise ValueError("unrecognized checkpoint extension in %r "
                         "(.params/.npz native, .pth/.pt/.bin torch)" % p)
    mapping = converted_mapping(net, load_torch_state(p), name, p)
    return apply_converted(net, mapping, ctx=ctx)


def _main(argv):
    """CLI: convert a torch checkpoint once into a native .params file."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.gluon.model_zoo.convert",
        description="convert a torchvision checkpoint into a .params file")
    ap.add_argument("name")
    ap.add_argument("ckpt")
    ap.add_argument("out")
    ap.add_argument("--device", default=None,
                    help="where the model is built (default: the current "
                         "CUDA device)")
    args = ap.parse_args(argv)
    from . import model_store
    from .vision import get_model

    net = get_model(args.name, pretrained=args.ckpt, ctx=args.device)
    net.save_parameters(args.out)
    # the sidecar marker makes the output eligible for model_store.purge,
    # never a .params placed by hand
    model_store.mark_managed(args.out)
    print("converted %s -> %s (%s)" % (args.ckpt, args.out, args.name))


if __name__ == "__main__":
    import sys

    _main(sys.argv[1:])
