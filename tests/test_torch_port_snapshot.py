"""Serving snapshots of the port's GenerativeServer on the CPU
(``serve.snapshot``, ``serve.load(prefix, snapshot=True)``,
``mxnet_tpu_torch.cache.snapshot``), against the JAX package's artifact
layout and manifest: a round trip (fp32 and int8, with and without a
``ModelDraft``) gives bit-equal parameters, the same program keys and the
original server's greedy tokens; a JAX artifact loads in the port (its
serialized executables ignored, with one warning) and a port artifact in
the JAX package (parameters and config: the fingerprints differ), each
with the writer's greedy tokens; a stale fingerprint warns once; a load
without ``draft=`` skips the speculative programs. Small GPT: 2 layers,
128 units, 2 heads of 64, vocab 256, max_length 512, fp32."""
import json
import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.gpt import GPTModel as JaxGPT
from mxnet_tpu_torch import quantization, serve
from mxnet_tpu_torch.base import DeviceError
from mxnet_tpu_torch.cache import snapshot as snap
from mxnet_tpu_torch.models.gpt import GPTModel as PortGPT
from mxnet_tpu_torch.serve import GenerativeServer, ModelDraft, ServeError
from torch_port_helpers import (SMALL_GPT, jax_gpt,  # noqa: F401
                                jax_trace_state_module, port_gpt_from)
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

NEW = 6
LENGTHS = (5, 17, 40)
BUCKETS = (8, 32, 64)
MAX_TOKENS = 64
# an int8 step's logits move with the step's other rows (one activation
# scale over all of them, free slots' rows too, whose pages hold what the
# warmup or the load left there), so an int8 stream may part from the
# original server's where the original's own token led by less than this
# (chip_smoke.py's INT8_TIE_TOL)
INT8_TIE_TOL = 0.15


@pytest.fixture(scope="module")
def shared(jax_trace_state_module):  # noqa: F811
    jm = jax_gpt(False)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, SMALL_GPT["vocab_size"], n).astype(np.int32)
               for n in LENGTHS]
    draft = PortGPT(**dict(SMALL_GPT, num_layers=1))
    draft.initialize(device="cpu",
                     generator=torch.Generator().manual_seed(3))
    return {"jax_model": jm, "prompts": prompts,
            "port_model": port_gpt_from(jm), "draft_model": draft}


def _pump(srv, streams, ticks=400):
    for _ in range(ticks):
        srv.step()
        if all(s.done() for s in streams):
            return [s.result(1) for s in streams]
        time.sleep(0.002)
    raise AssertionError("streams did not finish in %d ticks" % ticks)


def _greedy(srv, prompts):
    """Each prompt alone through the scheduler, greedy: the tokens do not
    depend on the other slots' traffic."""
    out = []
    for p in prompts:
        s = srv.submit(p, max_new_tokens=NEW)
        time.sleep(0.01)
        out.append(_pump(srv, [s])[0])
    return out


def _greedy_logits(srv, prompts):
    """:func:`_greedy` with the logits each token was taken from: the
    prefill's last row, then the stream's rows of each decode or verify
    step (one stream in flight at a time)."""
    rows = []
    prefill, step, verify = srv._prefill, srv._run_step, srv._run_verify

    def pre(slot, *args, **kwargs):
        out = prefill(slot, *args, **kwargs)
        rows.append(out[1].float().clone())
        return out

    def live(logits, n_emit):
        for s in np.flatnonzero(srv._active_mask()):
            rows.extend(logits[s].reshape(-1, logits.shape[-1])[
                :n_emit[s]].float().clone())

    def run_step(*args, **kwargs):
        logits = step(*args, **kwargs)
        live(logits, [1] * srv.slots)
        return logits

    def run_verify(*args, **kwargs):
        logits = verify(*args, **kwargs)
        live(logits, srv._emit[:, -1].tolist())
        return logits

    srv._prefill, srv._run_step, srv._run_verify = pre, run_step, run_verify
    try:
        toks = _greedy(srv, prompts)
    finally:
        del srv._prefill, srv._run_step, srv._run_verify
    return toks, rows


def _assert_within_ties(got, want, rows, tol):
    """Each stream of ``got`` equals ``want``'s up to a token where
    ``want``'s own logit led ``got``'s token by less than ``tol``."""
    rows = iter(rows)
    for g, w in zip(got, want):
        stream = [next(rows) for _ in w]
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                assert float(stream[i][b] - stream[i][a]) < tol, (g, w, i)
                break
        else:
            assert len(g) == len(w)


def _port_server(model, quantize=None, draft=None, **kw):
    srv = GenerativeServer(model, slots=2, device="cpu", quantize=quantize,
                           draft=draft, timeout_ms=600000.0, **kw)
    srv.warmup(prompt_buckets=BUCKETS, max_tokens=MAX_TOKENS)
    return srv


def _params(model):
    return {n: p._tensor().detach().clone()
            for n, p in model._collect_params_with_prefix().items()}


def _keys(srv):
    return [e["key"] for e in srv.export_executables()]


def _captured(keys):
    """The entries a load captures a program for; the eager ones (prefill,
    inject, extract, draftfill) are only kept."""
    return [k for k in keys
            if k.split("@")[0] in ("decode", "verify", "chunk", "draftstep")]


def _load(prefix, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        srv = serve.load(prefix, snapshot=True, device="cpu",
                         timeout_ms=600000.0, **kw)
    return srv, [str(w.message) for w in caught
                 if issubclass(w.category, RuntimeWarning)]


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("with_draft", [False, True])
def test_round_trip(shared, tmp_path, monkeypatch, quantize, with_draft):
    """snapshot -> load on a bare skeleton: parameters bit-equal, the
    listed step programs made at load and no other (the eager entries kept,
    not run), the same program keys, no
    program made while serving after it, the original server's greedy
    tokens (int8: up to a near-tie of the original's own logits,
    ``INT8_TIE_TOL``)."""
    model = port_gpt_from(shared["jax_model"])
    draft = ModelDraft(shared["draft_model"]) if with_draft else None
    srv = _port_server(model, quantize, draft)
    want, rows = _greedy_logits(srv, shared["prompts"])
    keys = _keys(srv)
    kinds = {k.split("@")[0] for k in keys}
    assert {"decode", "prefill", "inject", "extract"} <= kinds \
        if not with_draft else {"verify", "draftstep", "draftfill"} <= kinds
    prefix = str(tmp_path / "gen")
    path = serve.snapshot(srv, prefix)
    manifest = json.load(open(path))
    assert manifest["format"] == snap.FORMAT
    assert manifest["kind"] == "generative"
    assert sorted(manifest["executables"]) == keys
    assert not any("file" in fe for fe in manifest["executables"].values())
    assert manifest["quantize"] == quantize
    assert manifest["draft"] == ("ModelDraft" if with_draft else None)
    assert manifest["prompt_buckets"] == list(BUCKETS)

    kw = {"draft": ModelDraft(shared["draft_model"])} if with_draft else {}
    eager_runs = []
    for cls, name in ((GenerativeServer, "_prefill"),
                      (GenerativeServer, "_inject"),
                      (GenerativeServer, "_extract"), (ModelDraft, "_fill")):
        monkeypatch.setattr(cls, name, lambda *a, name=name, **k:
                            eager_runs.append(name))
    got, warned = _load(prefix, model=PortGPT(**SMALL_GPT), **kw)
    monkeypatch.undo()
    assert warned == []
    assert eager_runs == [], "load ran an eager path"
    assert got._quantize == quantize
    want_params, got_params = _params(srv.model), _params(got.model)
    assert sorted(want_params) == sorted(got_params)
    for name, t in want_params.items():
        assert torch.equal(got_params[name], t), name
    assert _keys(got) == keys
    stats = got.stats()
    assert stats["snapshot_programs"] == len(_captured(keys)) > 0
    made = stats["step_captures"]
    assert made == stats["step_programs"] > 0
    assert sorted(map(str, got._steps.keys())) == sorted(
        map(str, srv._steps.keys()))
    draft_made = stats["draft_step_captures"]
    if quantize:
        _assert_within_ties(_greedy(got, shared["prompts"]), want, rows,
                            INT8_TIE_TOL)
    else:
        assert _greedy(got, shared["prompts"]) == want
    stats = got.stats()
    assert stats["step_captures"] == made, "a program was made in traffic"
    assert stats["draft_step_captures"] == draft_made
    srv.stop()
    got.stop()


def test_a_jax_snapshot_loads_in_the_port(shared, tmp_path):
    """The JAX server's artifact: its checkpoint and config load in the
    port, its serialized executables are ignored with one warning, the
    fingerprint warns once, and the port serves the JAX server's greedy
    tokens."""
    jm = shared["jax_model"]
    jsrv = mx.serve.GenerativeServer(jm, slots=2, timeout_ms=600000.0)
    jsrv.warmup(prompt_buckets=BUCKETS, max_tokens=MAX_TOKENS)
    with jsrv:
        want = [jsrv.generate(p, max_new_tokens=NEW)
                for p in shared["prompts"]]
    prefix = str(tmp_path / "jax")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsrv.snapshot(prefix)
    manifest = snap.load_manifest(prefix)
    execs = manifest["executables"]
    got, warned = _load(prefix, model=PortGPT(**SMALL_GPT))
    assert sum("was made by" in w for w in warned) == 1
    n_files = sum("file" in fe for fe in execs.values())
    assert sum("serialized executables" in w for w in warned) == \
        (1 if n_files else 0)
    cap = got.cache.capacity
    assert cap == manifest["capacity"]
    listed = {k for k, fe in execs.items() if fe["capacity"] == cap}
    assert got.stats()["snapshot_programs"] == len(_captured(listed))
    assert set(_keys(got)) == listed
    assert _greedy(got, shared["prompts"]) == want
    got.stop()


def test_a_port_snapshot_loads_in_jax(shared, tmp_path):
    """The port's artifact in ``mxnet_tpu.serve.load(snapshot=True)``: the
    fingerprints differ, so the JAX package loads its checkpoint and config
    only, and serves the port server's greedy tokens."""
    srv = _port_server(shared["port_model"])
    want = _greedy(srv, shared["prompts"])
    prefix = str(tmp_path / "port")
    srv.snapshot(prefix)
    srv.stop()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jsrv = mx.serve.load(prefix, snapshot=True,
                             model=JaxGPT(**SMALL_GPT), timeout_ms=600000.0)
    assert any("loading checkpoint/config only" in str(w.message)
               for w in caught)
    assert jsrv.slots == srv.slots and jsrv.top_k == srv.top_k
    with jsrv:
        got = [jsrv.generate(p, max_new_tokens=NEW)
               for p in shared["prompts"]]
    assert got == want


def test_a_stale_fingerprint_warns_once_and_serves(shared, tmp_path):
    srv = _port_server(shared["port_model"])
    want = _greedy(srv, shared["prompts"][:1])
    prefix = str(tmp_path / "stale")
    path = srv.snapshot(prefix)
    srv.stop()
    manifest = json.load(open(path))
    assert manifest["fingerprint"] == snap.fingerprint("cpu")
    for part in ("torch=", "cuda=", "device=cpu", "csrc="):
        assert part in manifest["fingerprint"]
    manifest["fingerprint"] = manifest["fingerprint"].replace("csrc=",
                                                              "csrc=0")
    snap.atomic_write(path, json.dumps(manifest).encode())
    got, warned = _load(prefix, model=PortGPT(**SMALL_GPT))
    assert len(warned) == 1 and "was made by" in warned[0]
    assert got.stats()["snapshot_programs"] == len(
        _captured(manifest["executables"]))
    assert _greedy(got, shared["prompts"][:1]) == want
    got.stop()


def test_a_load_without_the_draft_skips_speculative_programs(shared,
                                                             tmp_path):
    srv = _port_server(shared["port_model"],
                       draft=ModelDraft(shared["draft_model"]))
    want = _greedy(srv, shared["prompts"])
    prefix = str(tmp_path / "spec")
    srv.snapshot(prefix)
    srv.stop()
    got, warned = _load(prefix, model=PortGPT(**SMALL_GPT))
    assert len(warned) == 1 and "no draft=" in warned[0]
    kinds = {k.split("@")[0] for k in _keys(got)}
    assert not kinds & {"verify", "draftstep", "draftfill"}
    assert got._draft is None and got.spec_k == srv.spec_k
    # greedy speculative streams are the plain greedy streams
    assert _greedy(got, shared["prompts"]) == want
    got.stop()


def test_what_the_port_does_not_snapshot(shared, tmp_path):
    """A ModelServer artifact is its model's export layout: it round trips
    through ``serve.load(snapshot=True)`` to a server with the same rows;
    a load without ``snapshot=True`` of a missing export layout raises; a
    serialized executable is refused; ``serve.stats()`` carries every live
    server and the process-wide count of programs made."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.serve import ModelServer

    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    ms = ModelServer(net, [((4,), "float32")], buckets=(1,), device="cpu")
    serve.snapshot(ms, str(tmp_path / "m"))
    back = serve.load(str(tmp_path / "m"), snapshot=True, device="cpu")
    x = np.arange(4, dtype=np.float32).reshape(1, 4)
    np.testing.assert_array_equal(back.predict(x)[0], ms.predict(x)[0])
    back.stop()
    srv = _port_server(shared["port_model"])
    with pytest.raises(ServeError, match="no serialized executable"):
        srv.preload_executable("decode", 0, srv.cache.capacity,
                               compiled=object())
    with pytest.raises(ServeError, match="no draft"):
        srv.preload_executable("verify", 0, srv.cache.capacity)
    with pytest.raises(FileNotFoundError):
        serve.load(str(tmp_path / "x"), ctx="cpu")
    st = serve.stats()
    assert st["step_capture_counter"] >= srv.stats()["step_captures"] > 0
    assert srv.name in st["servers"] and ms.name in st["servers"]
    srv.stop()
    ms.stop()


def test_a_bare_skeleton_is_quantized_on_the_card_unless_asked(
        monkeypatch):
    """``quantize_model`` and the fp8 probe on a model whose parameters
    hold no value yet take the port's default device, the card: without
    one they raise ``DeviceError`` instead of deciding on the CPU; with
    ``device="cpu"`` asked for, the CPU answers."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bare = PortGPT(**SMALL_GPT)
    with pytest.raises(DeviceError):
        quantization._param_device(bare)
    with pytest.raises(DeviceError):
        quantization.fp8_supported("e4m3")
    assert quantization.fp8_supported("e4m3", "cpu")
    bare.initialize(device="cpu")
    assert quantization._param_device(bare) == torch.device("cpu")


def test_a_bf16_snapshot_loads_dtype_exact(shared, tmp_path):
    """A bf16 server (amp: LayerNorm parameters stay fp32) loaded on a bare
    fp32 skeleton: every parameter keeps the file's dtype and bits, and the
    greedy tokens are the original server's."""
    from mxnet_tpu_torch import amp

    model = amp.convert_hybrid_block(port_gpt_from(shared["jax_model"]),
                                     "bfloat16")
    srv = _port_server(model)
    want = _greedy(srv, shared["prompts"][:2])
    prefix = str(tmp_path / "bf16")
    srv.snapshot(prefix)
    srv.stop()
    got, warned = _load(prefix, model=PortGPT(**SMALL_GPT))
    assert warned == []
    assert got.model.word_embed.weight.dtype == torch.bfloat16
    assert got.model.ln_f.gamma.dtype == torch.float32
    want_params, got_params = _params(srv.model), _params(got.model)
    for name, t in want_params.items():
        assert got_params[name].dtype == t.dtype, name
        assert torch.equal(got_params[name], t), name
    assert _greedy(got, shared["prompts"][:2]) == want
    got.stop()
