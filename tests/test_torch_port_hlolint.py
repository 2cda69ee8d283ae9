"""The program lint in the port (``analysis.hlolint``), over the op
records ``observability.costs`` keeps. Each rule with a meaning on the
record fires on a planted torch program as the JAX package's fires on its
planted StableHLO fixture, and stays silent on a clean one; GL021 only in
a hot tier; GL022 (undonated outputs) is recorded as not applicable. The
pinned CPU scenarios (BERT-small served in bf16, GPT-nano decode in bf16
and int8) lint clean against ``tools/torch_graphlint_allow.json``'s
``hlolint`` entries, with no stale entry; the kill switch empties the
section."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.analysis import hlolint as jhl
from mxnet_tpu_torch.analysis import hlolint as hl
from mxnet_tpu_torch.observability import costs
from torch_port_helpers import SMALL_BERT
from torch_port_helpers import keep_block_names  # noqa: F401

# block names made here do not shift the names later tests compare
pytestmark = pytest.mark.usefixtures("keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "hlolint")
ALLOW = os.path.join(REPO, "tools", "torch_graphlint_allow.json")


@pytest.fixture(autouse=True)
def fresh():
    costs.reset()
    yield
    costs.reset()


def _bf16(*shape):
    return torch.randn(*shape).to(torch.bfloat16)


def _widen(x, w):
    return x.float() @ w.float()


def _widen_ok(x, w):
    return (x @ w).float()


def _host(x):
    return x * x.sum().item()


def _host_ok(x):
    return x * x.sum()


def _bcast(x):
    return x.expand(256, 1024).clone()


def _bcast_ok(x):
    return x * torch.ones(256, 1024)


def _churn(x):
    q = x.to(torch.int8)
    return q.view(-1).to(torch.float32)


def _churn_ok(x):
    q = x.to(torch.int8)
    return (q * 2).to(torch.float32)


def _dup(x):
    y = x * 2.0
    return y, y


def _dup_ok(x):
    return x * 2.0, x * 3.0


# rule -> (tier, the planted program, a clean one, its inputs)
CASES = {
    "GL020": ("hybrid_capture", _widen, _widen_ok,
              lambda: (_bf16(32, 64), _bf16(64, 64))),
    "GL021": ("serve_capture", _host, _host_ok,
              lambda: (torch.ones(4, 4),)),
    "GL023": ("hybrid_capture", _bcast, _bcast_ok,
              lambda: (torch.ones(1, 1024),)),
    "GL024": ("decode_capture", _churn, _churn_ok,
              lambda: (torch.ones(8, 8),)),
    "GL025": ("serve_capture", _dup, _dup_ok, lambda: (torch.ones(4),)),
}


def _lint(tier, fn, args, hint):
    """``fn(*args)`` counted as a program of ``tier`` (the inputs made
    before, as a program's arguments are), then the corpus linted."""
    costs.run_counted(costs.meter(tier, hint, "cpu"), lambda: fn(*args))
    return hl.lint_corpus()


@pytest.mark.parametrize("rule", sorted(CASES))
def test_planted_programs_give_the_jax_ids(rule):
    tier, bad, good, args = CASES[rule]
    got = {f.rule for f in _lint(tier, bad, args(), "planted")}
    assert rule in got, got
    costs.reset()
    assert rule not in {f.rule for f in _lint(tier, good, args(), "clean")}
    with open(os.path.join(FIXDIR, "%s_pos.mlir" % rule.lower())) as fh:
        jtier = "decode" if rule == "GL021" else "jit"
        assert rule in {f.rule for f in jhl.lint_text(fh.read(),
                                                      tier=jtier)}


def test_host_rule_only_in_hot_tiers():
    assert "GL021" not in {f.rule for f in _lint(
        "bulk_compile", _host, (torch.ones(4, 4),), "cold")}


def test_findings_carry_cost_and_rank():
    found = _lint("hybrid_capture", _widen, (_bf16(32, 64), _bf16(64, 64)),
                  "w")
    (f,) = [x for x in found if x.rule == "GL020"]
    assert f.key == "hybrid_capture:w::GL020::bfloat16->float32->mm"
    assert f.cost_flops == 2 * 32 * 64 * 64 and f.cost_bytes > 0
    assert f.nbytes == 64 * 64 * 4
    assert hl.rank(found) == found


def test_undonated_outputs_not_applicable():
    with open(os.path.join(FIXDIR, "gl022_pos.mlir")) as fh:
        assert "GL022" in {f.rule for f in jhl.lint_text(fh.read(),
                                                         tier="decode")}
    assert "GL022" not in hl.RULES
    assert hl.NOT_APPLICABLE["GL022"].startswith("not applicable, because")
    assert set(jhl.RULES) - set(hl.RULES) == {"GL022"}


def test_pinned_scenarios_lint_clean_against_the_allowlist():
    from mxnet_tpu_torch.models.bert import BERTModel
    from mxnet_tpu_torch.models.gpt import gpt_nano
    from mxnet_tpu_torch.serve import GenerativeServer, ModelServer

    with mx.cpu():
        b = BERTModel(**SMALL_BERT)
        b.initialize()
        b.cast("bfloat16")
        ModelServer(b, [((64,), "int32"), ((64,), "int32"),
                        ((), "int32")], buckets=(2,),
                    name="serve:bert-small").stop()
        for q in (None, "int8"):
            m = gpt_nano()
            m.initialize()
            m.cast("bfloat16")
            srv = GenerativeServer(m, slots=2, quantize=q)
            with srv:
                srv.submit(np.arange(5, dtype=np.int32),
                           max_new_tokens=3).result(timeout_s=60)
    found = hl.lint_corpus()
    kept, suppressed, stale = hl.split_allowed(found, hl.load_allowlist(ALLOW))
    assert kept == [], "\n".join(f.render() for f in kept)
    assert stale == [] and suppressed
    sec = hl.snapshot_section()
    assert sec["programs"] == 3 and sec["total_findings"] == len(found)
    prev = hl.set_enabled(False)
    try:
        assert hl.snapshot_section()["findings"] == []
    finally:
        hl.set_enabled(prev)
