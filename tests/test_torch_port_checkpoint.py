"""Checkpoints cross between the packages: parameter files (fp32 and bf16,
bit-exact both ways, deduplicated aliases), ``checkpoint.validate_swap``'s
verdicts, arrays, whole checkpoints, and Trainer state files of each of
the fifteen optimizers (``multi_precision``: every leaf with its layout
and dtype, and the next step after a load matches the other package's
within 1e-6 in fp32; SGLD's noise drawn as zeros in both); and the
GenerativeServer's weight swap."""
import pickle

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import util as jutil
from mxnet_tpu_torch import autograd, checkpoint, gluon
from mxnet_tpu_torch.util import tree_leaves
from mxnet_tpu_torch.models.gpt import GPTModel
from mxnet_tpu_torch.serve import GenerativeServer
from torch_port_helpers import (JAX_DOUBLE_DONATION, OPTIMIZER_KW,  # noqa: F401
                                SMALL_GPT, jax_gpt, jax_trace_state,
                                port_gpt_from, sgld_without_noise)

ADAM = {"learning_rate": 1e-2, "wd": 0.01, "multi_precision": True}


def _bits(x):
    """A tensor's or array's raw bits, for bit-exact comparisons."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.view(torch.int16 if t.element_size() == 2 else
                      torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _jax_structural(model):
    return {n: p.data()._data for n, p in
            model._collect_params_with_prefix().items()}


def _port_structural(model):
    return {n: p._tensor()
            for n, p in model._collect_params_with_prefix().items()}


@pytest.mark.parametrize("bf16", [False, True])
def test_parameter_files_cross_bit_exact(jax_trace_state, tmp_path,  # noqa: F811
                                         bf16):
    jm = jax_gpt(bf16)
    jm.save_parameters(str(tmp_path / "jax.params"))
    tm = GPTModel(**SMALL_GPT)
    tm.load_parameters(str(tmp_path / "jax.params"), ctx="cpu",
                       cast_dtype=True, dtype_source="saved")
    want = _jax_structural(jm)
    got = _port_structural(tm)
    assert sorted(got) == sorted(want)
    for name in want:
        assert str(got[name].dtype)[6:] == str(want[name].dtype), name
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))
    # and back: the port's file into a fresh JAX model of the same dtype
    tm.save_parameters(str(tmp_path / "port.params"))
    jm2 = jax_gpt(bf16)
    jm2.load_parameters(str(tmp_path / "port.params"))
    for name, arr in _jax_structural(jm2).items():
        np.testing.assert_array_equal(_bits(arr), _bits(want[name]))


def test_load_casts_to_the_parameter_dtype_and_refuses_mismatches(
        jax_trace_state, tmp_path):  # noqa: F811
    jm = jax_gpt(True)
    path = str(tmp_path / "bf16.params")
    jm.save_parameters(path)
    tm = GPTModel(**SMALL_GPT)
    tm.initialize(device="cpu")
    tm.load_parameters(path)  # dtype_source "current": stays fp32
    assert tm.word_embed.weight._tensor().dtype == torch.float32
    np.testing.assert_array_equal(
        tm.word_embed.weight._tensor().detach().numpy(),
        np.asarray(jm.word_embed.weight.data()._data, np.float32))
    small = GPTModel(**dict(SMALL_GPT, num_layers=1))
    with pytest.raises(KeyError, match="Extra parameters"):
        small.load_parameters(path, ctx="cpu")
    small.load_parameters(path, ctx="cpu", ignore_extra=True)
    big = GPTModel(**dict(SMALL_GPT, num_layers=3))
    with pytest.raises(KeyError, match="missing"):
        big.load_parameters(path, ctx="cpu")
    # a file keyed by global names (the legacy format) is refused
    legacy = str(tmp_path / "legacy.params")
    jutil.save_npz_exact(legacy, {p.name: np.asarray(p.data()._data)
                                  for p in jm.collect_params().values()})
    with pytest.raises(KeyError, match="legacy"):
        tm.load_parameters(legacy)
    with pytest.raises(RuntimeError, match="not initialized"):
        GPTModel(**SMALL_GPT).save_parameters(str(tmp_path / "none.params"))


def _shared_pair(nn):
    """Two Dense layers sharing one weight and bias (``params=``)."""
    net = nn.HybridSequential()
    with net.name_scope():
        d1 = nn.Dense(4, in_units=3)
        d2 = nn.Dense(4, in_units=3, params=d1.params)
    net.add(d1, d2)
    return net


def test_deduplicated_files_and_aliases_cross(jax_trace_state,  # noqa: F811
                                              tmp_path):
    jnet = _shared_pair(jgluon.nn)
    jnet.initialize()
    path = str(tmp_path / "dedup.params")
    jnet.save_parameters(path, deduplicate=True)
    keys = sorted(np.load(path).files)
    tnet = _shared_pair(gluon.nn)
    assert sorted(tnet._collect_params_with_prefix()) == \
        ["0.bias", "0.weight", "1.bias", "1.weight"]
    tnet.load_parameters(path, ctx="cpu")
    assert tnet[0].weight is tnet[1].weight
    np.testing.assert_array_equal(tnet[1].weight._tensor().detach().numpy(),
                                  np.asarray(jnet[0].weight.data()._data))
    tnet.save_parameters(str(tmp_path / "port.params"), deduplicate=True)
    assert sorted(np.load(str(tmp_path / "port.params")).files) == keys \
        == ["0.bias", "0.weight"]
    # a file holding only the second alias loads too
    only_second = str(tmp_path / "second.params")
    jutil.save_npz_exact(only_second, {
        "1.weight": np.ones((4, 3), np.float32),
        "1.bias": np.zeros(4, np.float32)})
    tnet.load_parameters(only_second)
    assert float(tnet[0].weight._tensor().detach().sum()) == 12.0


@pytest.mark.parametrize("problem", ["missing", "extra", "reshaped", "dtype",
                                     "none"])
def test_validate_swap_gives_the_jax_verdict(jax_trace_state, tmp_path,  # noqa: F811
                                             problem):
    jm = jax_gpt(False)
    tm = port_gpt_from(jm)
    arrays = {n: np.asarray(a) for n, a in _jax_structural(jm).items()}
    if problem == "missing":
        del arrays["blocks.1.ln2.beta"]
    elif problem == "extra":
        arrays["blocks.9.ln2.beta"] = np.zeros(128, np.float32)
    elif problem == "reshaped":
        arrays["ln_f.gamma"] = np.ones(64, np.float32)
    elif problem == "dtype":
        arrays["pos_embed.weight"] = arrays["pos_embed.weight"].astype(
            ml_dtypes.bfloat16)
    path = str(tmp_path / "swap.params")
    jutil.save_npz_exact(path, arrays)
    if problem == "none":
        picked = checkpoint.validate_swap(tm, path)
        assert sorted(picked) == sorted(arrays)
        assert sorted(jckpt.validate_swap(jm, path)) == sorted(arrays)
        return
    with pytest.raises(jckpt.SwapError) as want:
        jckpt.validate_swap(jm, path)
    with pytest.raises(checkpoint.SwapError) as got:
        checkpoint.validate_swap(tm, path)
    assert str(got.value) == str(want.value)
    assert problem in str(got.value)


def test_arrays_and_checkpoints_cross(jax_trace_state, tmp_path):  # noqa: F811
    arrays = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.tensor([1.5, -2.25]).to(torch.bfloat16)}
    checkpoint.save_arrays(str(tmp_path / "x.npz"), arrays)
    back = jckpt.load_arrays(str(tmp_path / "x.npz"))
    assert str(back["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(_bits(back["b"]._data), _bits(arrays["b"]))
    jckpt.save_arrays(str(tmp_path / "y.npz"), back)
    again = checkpoint.load_arrays(str(tmp_path / "y.npz"))
    for k in arrays:
        assert again[k].dtype == arrays[k].dtype
        assert torch.equal(again[k], arrays[k])

    # a whole checkpoint: the port's, read by the port and by JAX
    jnet, jtr = _jax_mlp(False)
    _jax_step(jnet, jtr, _x(0))
    tnet, ttr = _port_mlp_from_files(jnet, jtr, tmp_path)
    prefix = str(tmp_path / "ckpt" / "run")
    checkpoint.save_checkpoint(prefix, 3, tnet, ttr, extra={"lr": 0.1})
    tnet2, ttr2 = _port_mlp()
    meta = checkpoint.load_checkpoint(prefix, 3, tnet2, ttr2)
    assert meta == {"epoch": 3, "extra": {"lr": 0.1}}
    for a, b in zip(_leaves(ttr), _leaves(ttr2)):
        assert torch.equal(a, b)
    jnet2, jtr2 = _jax_mlp(False)
    _jax_step(jnet2, jtr2, _x(1))  # states to fill
    assert jckpt.load_checkpoint(prefix, 3, jnet2, jtr2)["epoch"] == 3
    for name, arr in _jax_structural(jnet2).items():
        np.testing.assert_array_equal(
            np.asarray(arr), _port_structural(tnet)[name].detach().numpy())


# ------------------------------------------------------- trainer states


def _mlp(nn, bf16):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(5, in_units=4, activation="tanh"),
                nn.Dense(3, in_units=5))
    return net


def _opt_kw(opt):
    return ADAM if opt == "adam" else dict(
        OPTIMIZER_KW[opt], wd=0.01, multi_precision=True)


def _jax_mlp(bf16, opt="adam"):
    net = _mlp(jgluon.nn, bf16)
    net.initialize()
    if bf16:
        net.cast("bfloat16")
    trainer = jgluon.Trainer(net.collect_params(), opt, _opt_kw(opt))
    trainer._fused_opt = opt not in JAX_DOUBLE_DONATION
    return net, trainer


def _port_mlp(bf16=False, opt="adam"):
    net = _mlp(gluon.nn, bf16)
    net.initialize(device="cpu")
    if bf16:
        net.cast("bfloat16")
    return net, gluon.Trainer(net.collect_params(), opt, _opt_kw(opt))


def _x(seed):
    return np.random.RandomState(seed).randn(6, 4).astype(np.float32)


def _jax_step(net, trainer, x):
    with jag.record():
        y = net(mx.nd.array(x).astype(net[0].weight.data().dtype))
        loss = (y * y).sum()
    jag.backward(loss)
    trainer.step(1)


def _port_step(net, trainer, x):
    with autograd.record():
        y = net(torch.from_numpy(x).to(net[0].weight._tensor().dtype))
        loss = (y * y).sum()
    autograd.backward(loss)
    trainer.step(1)


def _leaves(trainer):
    return [t for _, t in trainer._leaves()]


def _port_mlp_from_files(jnet, jtr, tmp_path, bf16=False, opt="adam"):
    jnet.save_parameters(str(tmp_path / "j.params"))
    jtr.save_states(str(tmp_path / "j.states"))
    tnet, ttr = _port_mlp(bf16, opt)
    tnet.load_parameters(str(tmp_path / "j.params"))
    ttr.load_states(str(tmp_path / "j.states"))
    return tnet, ttr


def _assert_same_after_next_step(jnet, jtr, tnet, ttr):
    _jax_step(jnet, jtr, _x(1))
    _port_step(tnet, ttr, _x(1))
    for name, arr in _jax_structural(jnet).items():
        np.testing.assert_allclose(
            _port_structural(tnet)[name].detach().numpy(), np.asarray(arr),
            atol=1e-6, rtol=0, err_msg=name)
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jtr._states)]
    assert len(jleaves) == len(_leaves(ttr))
    for a, b in zip(_leaves(ttr), jleaves):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0)
    assert ttr._optimizer.num_update == jtr._optimizer.num_update == 2
    assert ttr._optimizer._index_update_count == \
        jtr._optimizer._index_update_count


@pytest.mark.parametrize("opt", sorted(OPTIMIZER_KW))
def test_trainer_states_from_jax_give_the_jax_next_step(
        opt, jax_trace_state, sgld_without_noise, tmp_path):  # noqa: F811
    jnet, jtr = _jax_mlp(False, opt)
    _jax_step(jnet, jtr, _x(0))
    tnet, ttr = _port_mlp_from_files(jnet, jtr, tmp_path, opt=opt)
    _assert_same_after_next_step(jnet, jtr, tnet, ttr)


@pytest.mark.parametrize("opt", sorted(OPTIMIZER_KW))
def test_trainer_states_from_the_port_give_the_jax_next_step(
        opt, jax_trace_state, sgld_without_noise, tmp_path):  # noqa: F811
    tnet, ttr = _port_mlp(opt=opt)
    _port_step(tnet, ttr, _x(0))
    tnet.save_parameters(str(tmp_path / "t.params"))
    ttr.save_states(str(tmp_path / "t.states"))
    jnet, jtr = _jax_mlp(False, opt)
    jnet.load_parameters(str(tmp_path / "t.params"))
    jtr.load_states(str(tmp_path / "t.states"))
    _assert_same_after_next_step(jnet, jtr, tnet, ttr)


@pytest.mark.parametrize("opt", sorted(OPTIMIZER_KW))
def test_trainer_state_order_with_fp32_masters(opt,  # noqa: F811
                                               jax_trace_state, tmp_path):
    """bf16 weights with fp32 masters: each state is {"master", "state":
    the optimizer's state}, flattened as the master, then the inner
    state's leaves (Adam's mean and variance) per parameter. The port
    takes each array to its place, with its dtype, and writes the same
    file."""
    jnet, jtr = _jax_mlp(True, opt)
    _jax_step(jnet, jtr, _x(0))
    tnet, ttr = _port_mlp_from_files(jnet, jtr, tmp_path, bf16=True, opt=opt)
    for i, s in ttr._states.items():
        js = jtr._states[i]
        np.testing.assert_array_equal(s["master"].numpy(),
                                      np.asarray(js["master"]))
        inner = jax.tree_util.tree_leaves(js["state"])
        assert len(tree_leaves(s["state"])) == len(inner)
        for a, b in zip(tree_leaves(s["state"]), inner):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ttr.save_states(str(tmp_path / "t.states"))
    with open(str(tmp_path / "j.states"), "rb") as f:
        want = pickle.load(f)
    with open(str(tmp_path / "t.states"), "rb") as f:
        got = pickle.load(f)
    assert got["num_update"] == want["num_update"]
    assert got["update_count"] == want["update_count"]
    assert len(got["arrays"]) == len(want["arrays"]) == len(
        jax.tree_util.tree_leaves(jtr._states))
    if opt == "adam":
        assert len(got["arrays"]) == 3 * 4
    for a, b in zip(got["arrays"], want["arrays"]):
        assert a.dtype == b.dtype == (np.uint32 if opt == "sgld" and a.shape
                                      == (2,) else np.float32)
        np.testing.assert_array_equal(a, b)


def test_a_bf16_state_array_raises_naming_it(tmp_path):
    tnet, ttr = _port_mlp()
    _port_step(tnet, ttr, _x(0))
    ttr.save_states(str(tmp_path / "t.states"))
    with open(str(tmp_path / "t.states"), "rb") as f:
        blob = pickle.load(f)
    blob["arrays"][3] = blob["arrays"][3].astype(ml_dtypes.bfloat16)
    with open(str(tmp_path / "bf16.states"), "wb") as f:
        pickle.dump(blob, f)
    before = [t.clone() for t in _leaves(ttr)]
    with pytest.raises(TypeError, match=r"arrays\[3\].*bfloat16"):
        ttr.load_states(str(tmp_path / "bf16.states"))
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(ttr)))
    blob["arrays"] = blob["arrays"][:-1]
    with open(str(tmp_path / "short.states"), "wb") as f:
        pickle.dump(blob, f)
    with pytest.raises(ValueError, match="state arrays"):
        ttr.load_states(str(tmp_path / "short.states"))


# --------------------------------------------------------- weight swap


def _gpt(seed):
    m = GPTModel(**SMALL_GPT)
    m.initialize(device="cpu", generator=torch.Generator().manual_seed(seed))
    return m


def test_swap_parameters_flips_the_weights_and_flushes_prefixes(tmp_path):
    a, b = _gpt(0), _gpt(1)
    prompt = np.arange(7, dtype=np.int32)
    want_a = a.generate(prompt[None], 8, device="cpu")[0, 7:].tolist()
    want_b = b.generate(prompt[None], 8, device="cpu")[0, 7:].tolist()
    path = str(tmp_path / "b.params")
    b.save_parameters(path)
    srv = GenerativeServer(a, slots=2, timeout_ms=600000.0, device="cpu")
    with srv:
        before = srv.generate(prompt, max_new_tokens=8)
        assert len(srv.prefix) == 1
        assert srv.swap_parameters(path) == 1
        assert len(srv.prefix) == 0 and srv.stats()["swap_epoch"] == 1
        after = srv.generate(prompt, max_new_tokens=8)
        # a file that does not match is refused; the weights stay
        bad = str(tmp_path / "bad.params")
        arrays = {n: p._tensor() for n, p in
                  b._collect_params_with_prefix().items()}
        del arrays["ln_f.beta"]
        checkpoint.save_arrays(bad, arrays)
        with pytest.raises(checkpoint.SwapError, match="missing 'ln_f.beta'"):
            srv.swap_parameters(bad)
        again = srv.generate(prompt, max_new_tokens=8)
    assert before == want_a and before != want_b
    assert after == again == want_b
    assert srv.prefix.misses == 2 and srv.prefix.hits == 1
