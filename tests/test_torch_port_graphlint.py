"""The port's graphlint (stage 1): the JAX package's rule IDs, retargeted
to torch. On each of the JAX package's planted fixtures whose hazard is
plain Python, the port's linter gives the findings (line and rule) the
JAX linter gives; the hazards the JAX fixtures spell in JAX (a per-call
``jax.jit``, a direct ``jax.jit``) are planted in torch (a per-call
``torch.compile`` or CUDA graph, a direct ``torch.compile``) and give the
same IDs; GL005 (use after donation) is recorded as not
applicable. The port's own package lints clean against
``tools/torch_graphlint_allow.json``, with no stale entry."""
import glob
import os

import pytest

from mxnet_tpu.analysis import graphlint as jgl
from mxnet_tpu_torch.analysis import graphlint as gl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "graphlint")
ALLOW = os.path.join(REPO, "tools", "torch_graphlint_allow.json")
# the JAX fixtures that spell their hazard in JAX: planted in torch below
JAX_SPELLED = {"GL002", "GL008"}
# (GL011-GL015, the concurrency rules, are test_torch_port_concurrency's)
NEUTRAL = sorted(
    r for r in (os.path.basename(p)[:5].upper()
                for p in glob.glob(os.path.join(FIXDIR, "gl0*_pos.py")))
    if r not in JAX_SPELLED | {"GL005"} and not "GL011" <= r <= "GL015")

TORCH_PLANTED = {
    "GL002": '''
import torch


def run_per_call(x):
    y = torch.compile(lambda a: a + 1)(x)               # expect: GL002
    key = tuple({"b", "a"})                             # expect: GL002
    return y, key


def run_local_fn(x):
    def body(a):
        return a * 2

    return torch.compile(body)(x)                       # expect: GL002


def capture_per_call(fn, x):
    g = torch.cuda.CUDAGraph()                          # expect: GL002
    with torch.cuda.graph(g):
        fn(x)
    g.replay()
''',
    "GL008": '''
import torch


def build_step(fn):
    step = torch.compile(fn)                            # expect: GL008
    return step


def own_graph():
    return torch.cuda.CUDAGraph()                       # expect: GL008
''',

}
TORCH_CLEAN = {
    "GL002": '''
import torch

_STEP = torch.compile(lambda a: a + 1)


def run(x, keys):
    return _STEP(x), tuple(sorted(set(keys)))


class Programs:
    def capture(self, fn, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(x)
        self.graph = g
''',
    "GL008": '''
from mxnet_tpu_torch.capture import capture_graph


def build(fn, device, pool):
    return capture_graph(fn, device, pool)
''',

}


def _markers(src):
    return {(i, line.split("# expect:")[1].strip())
            for i, line in enumerate(src.splitlines(), 1)
            if "# expect:" in line}


def _read(rule, kind):
    path = os.path.join(FIXDIR, "%s_%s.py" % (rule.lower(), kind))
    with open(path) as fh:
        return path, fh.read()


@pytest.mark.parametrize("rule", NEUTRAL)
def test_jax_fixtures_give_the_jax_findings(rule):
    path, src = _read(rule, "pos")
    rel = os.path.relpath(path, REPO)
    mine = {(f.line, f.rule) for f in gl.lint_source(src, rel)
            if f.rule == rule}
    theirs = {(f.line, f.rule) for f in jgl.lint_source(src, rel)
              if f.rule == rule}
    assert mine == theirs and _markers(src) <= mine, (mine, theirs)
    npath, nsrc = _read(rule, "neg")
    assert [f for f in gl.lint_source(nsrc, npath) if f.rule == rule] == []


@pytest.mark.parametrize("rule", sorted(JAX_SPELLED))
def test_torch_planted_give_the_jax_rule(rule):
    src = TORCH_PLANTED[rule]
    got = {(f.line, f.rule) for f in gl.lint_source(src, "planted.py")
           if f.rule == rule}
    assert got == _markers(src), got
    assert [f for f in gl.lint_source(TORCH_CLEAN[rule], "clean.py")
            if f.rule == rule] == []
    # the JAX package's planted case of the same hazard: the same ID
    path, jsrc = _read(rule, "pos")
    assert rule in {f.rule for f in jgl.lint_source(jsrc, path)}


def test_donation_is_not_applicable():
    path, src = _read("GL005", "pos")
    assert "GL005" in {f.rule for f in jgl.lint_source(src, path)}
    assert "GL005" not in gl.RULES
    assert gl.NOT_APPLICABLE["GL005"].startswith("not applicable, because")
    assert "GL005" not in {f.rule for f in gl.lint_source(src, path)}
    assert set(jgl.RULES) - set(gl.RULES) == {"GL005"}


def test_inline_disable_and_deterministic_output():
    src = ("class B:\n"
           "    def hybrid_forward(self, F, x):\n"
           "        return float(F.sum(x))  # graphlint: disable=GL001\n")
    assert gl.lint_source(src, "x.py") == []
    path, psrc = _read("GL001", "pos")
    a, b = gl.lint_source(psrc, path), gl.lint_source(psrc, path)
    assert a == b and a == sorted(a, key=lambda f: (f.path, f.line, f.rule,
                                                    f.msg))


def test_port_package_is_clean_against_its_allowlist():
    allow = gl.load_allowlist(ALLOW)
    assert allow and all(why.strip() for why in allow.values())
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        findings = gl.lint_paths(["mxnet_tpu_torch"])
    finally:
        os.chdir(cwd)
    kept, suppressed, stale = gl.split_allowed(findings, allow)
    assert kept == [], "new findings:\n" + gl.format_findings(kept)
    assert stale == [], "stale allowlist entries: %s" % stale
    assert len(suppressed) >= len(allow)


def test_allowlist_requires_a_why(tmp_path):
    bad = tmp_path / "allow.json"
    bad.write_text('{"graphlint": [{"id": "a.py::GL001::f", "why": " "}]}')
    with pytest.raises(ValueError):
        gl.load_allowlist(str(bad))
