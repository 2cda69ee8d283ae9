"""hlolint: the program lint (counterpart of ``mxnet_tpu/analysis/
hlolint.py``), over the op record of each program the port builds.

graphlint (GL001-GL017) and racecheck (GL011-GL015) lint the Python that
builds programs; this module lints the programs. The JAX package lints
the StableHLO text of every program its cost seam records; the port has
no such text, and its counterpart is the op record ``observability.costs``
keeps of each program's counted run: every aten (or kernel) op with the
shapes, dtypes and devices of its tensors, the value identities between
ops and what the program returns. Each JAX rule that has a meaning on that
record carries over, under its ID:

* GL020: unintended float32 widening in a low-precision program: an
  explicit conversion (``aten._to_copy`` / ``aten.to``) from bf16, fp16,
  int8 or fp8 to float32/64 whose value reaches a product or a reduction
  (through views only), in a program whose inputs are low-precision.
* GL021: a host round trip inside a hot-tier program (``serve_capture``,
  ``decode_capture``, ``tape_compile``): ``aten._local_scalar_dense`` (an
  ``.item()``), or a copy from the card to the host.
* GL023: a broadcast materialized: a copy of an expanded (stride-0) value,
  or a ``repeat``, whose result is large and a large multiple of its
  source.
* GL024: convert churn: a narrowing conversion whose value reaches a
  widening one back through data movement only (views, copies, cache
  writes).
* GL025: a dead or duplicate program output: one value returned twice, or
  an input returned untouched.

``NOT_APPLICABLE`` records the rest: GL022 (an undonated output).

Findings carry the program's tier, hint and key, the rule's byte count and
the program's flops and bytes from the cost ledger, so :func:`rank` orders
them by what they cost. The tier-1 suite lints the programs of its
scenarios against ``tools/torch_graphlint_allow.json``'s ``hlolint``
entries (per-entry ``why`` required). Kill switch: ``MXNET_HLOLINT=0`` (or
:func:`set_enabled`).
"""
from __future__ import annotations

import json
import os
import threading
from typing import NamedTuple

RULES = {
    "GL020": "unintended f32 widening in a low-precision program",
    "GL021": "host round-trip inside a hot-tier program",
    "GL023": "byte-multiplying broadcast materializing copies",
    "GL024": "convert-churn: quantize->dequantize with no compute between",
    "GL025": "dead or duplicate program output",
}

NOT_APPLICABLE = {
    "GL022": "not applicable, because torch has no buffer donation: an "
             "output can never alias an input's buffer, so no undonated "
             "output is a missed reuse",
}

#: tiers whose programs sit on a per-request or per-token hot path
HOT_TIERS = frozenset({"serve_capture", "decode_capture", "tape_compile"})

#: dtypes that mark a program as deliberately low-precision (GL020)
LOW_PRECISION = frozenset({"bfloat16", "float16", "int8", "uint8",
                           "float8_e4m3fn", "float8_e5m2"})

_CONVERTS = frozenset({"aten._to_copy.default", "aten.to.dtype",
                       "aten.to.dtype_layout", "aten.to.device",
                       "aten._to_copy.out"})

#: compute sinks a widening conversion must reach for GL020
_SINKS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "convolution",
    "_convolution", "cudnn_convolution", "sum", "mean", "amax", "amin",
    "prod", "var", "std", "var_mean", "logsumexp", "_softmax",
    "_log_softmax", "flash_fwd", "flash_fwd_f32", "flash_bwd"})

#: ops a value moves through without being computed on (GL020 reach and
#: GL024's no-compute condition)
_PASSTHROUGH = frozenset({
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "slice", "select", "unsqueeze", "squeeze", "clone",
    "contiguous", "copy_", "copy", "cat", "stack", "index", "index_put_",
    "index_put", "index_select", "gather", "scatter", "alias", "detach",
    "as_strided", "split", "unbind", "narrow", "flatten", "unflatten",
    "lift_fresh", "_reshape_alias"})

_ITEMSIZE = {"float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
             "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
             "complex64": 8, "complex128": 16}


def _env_enabled():
    v = os.environ.get("MXNET_HLOLINT", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


_enabled = _env_enabled()
_lock = threading.Lock()
#: GL023 thresholds (the JAX package's defaults): result size, source
#: size (no scalar splats), factor
BCAST_MIN_OUT = 256 * 1024
BCAST_MIN_IN = 1024
BCAST_FACTOR = 8


def itemsize(dtype):
    return _ITEMSIZE.get(dtype, 1)


def _nbytes(desc):
    n = 1
    for s in desc[1]:
        n *= s
    return n * itemsize(desc[2])


def _short(op):
    """``aten.mm.default`` -> ``mm``; a kernel op likewise."""
    parts = op.split(".")
    return parts[1] if len(parts) >= 2 else op


class Program:
    """An op record with its def-use tables."""

    def __init__(self, ops):
        self.ops = [o for o in ops if o["op"] != "return"]
        ret = [o for o in ops if o["op"] == "return"]
        self.results = [d[0] for d in ret[0]["ins"]] if ret else []
        self.defs = {}      # value id -> (op index, desc)
        self.uses = {}      # value id -> [op index]
        self.args = {}      # argument value id -> desc
        for i, o in enumerate(self.ops):
            for d in o["ins"]:
                self.uses.setdefault(d[0], []).append(i)
                if d[0].startswith("arg"):
                    self.args.setdefault(d[0], d)
            for d in o["outs"]:
                self.defs.setdefault(d[0], (i, d))

    def reach(self, vid, start, stop):
        """The first op index, after op ``start`` made ``vid``, reached
        from it through passthrough ops (each after the one before: an
        in-place write is no path for the reads before it) for which
        ``stop(op)`` holds, or None."""
        seen, frontier = {(vid, start)}, [(vid, start)]
        while frontier:
            v, at = frontier.pop()
            for i in self.uses.get(v, ()):
                if i <= at:
                    continue
                o = self.ops[i]
                if stop(o):
                    return i
                if _short(o["op"]) in _PASSTHROUGH:
                    for d in o["outs"]:
                        if (d[0], i) not in seen:
                            seen.add((d[0], i))
                            frontier.append((d[0], i))
        return None


class Finding(NamedTuple):
    """One program-level finding, joined to the cost ledger."""
    rule: str
    tier: str
    hint: str
    pkey: str             # the program's content key
    scope: str            # stable detail for the allowlist key
    msg: str
    op: str               # the offending op's name
    op_name: str          # provenance (the port's ops carry none: "")
    nbytes: int           # rule-specific byte count
    cost_bytes: float     # the program's bytes from the cost ledger
    cost_flops: float     # the program's flops from the cost ledger

    @property
    def key(self):
        """Allowlist identity, free of the program key: it survives edits
        that keep the tier, hint and scope."""
        return "%s:%s::%s::%s" % (self.tier, self.hint, self.rule,
                                  self.scope)

    def render(self):
        cost = (", program MB=%.3f" % (self.cost_bytes / 1e6)
                if self.cost_bytes else "")
        return "%s:%s [%s] %s (%s, %d bytes%s)" % (
            self.tier, self.hint, self.rule, self.msg, self.op,
            self.nbytes, cost)

    def as_dict(self):
        d = self._asdict()
        d["key"] = self.key
        return d


def _hit(rule, scope, msg, op="", nbytes=0):
    return {"rule": rule, "scope": scope, "msg": msg, "op": op,
            "nbytes": int(nbytes)}


def _convert(o):
    """(source desc, result desc) of a conversion op, else None."""
    if o["op"] not in _CONVERTS or not o["ins"] or not o["outs"]:
        return None
    return o["ins"][0], o["outs"][0]


def _rule_gl020(prog, tier):
    if not any(d[2] in LOW_PRECISION for d in prog.args.values()):
        return []
    out = []
    for at, o in enumerate(prog.ops):
        cv = _convert(o)
        if cv is None:
            continue
        src, dst = cv
        if src[2] not in LOW_PRECISION or dst[2] not in ("float32",
                                                           "float64"):
            continue
        i = prog.reach(dst[0], at, lambda u: _short(u["op"]) in _SINKS)
        if i is not None:
            sink = _short(prog.ops[i]["op"])
            out.append(_hit(
                "GL020", "%s->%s->%s" % (src[2], dst[2], sink),
                "conversion %s->%s feeds %s in a program whose inputs are "
                "%s: compute it in the narrow dtype (or accumulate wider "
                "inside the product) instead of widening the operand"
                % (src[2], dst[2], sink, src[2]),
                prog.ops[i]["op"], _nbytes(dst)))
    return out


def _rule_gl021(prog, tier):
    if tier not in HOT_TIERS:
        return []
    out = []
    for o in prog.ops:
        short = _short(o["op"])
        if short == "_local_scalar_dense":
            what = "a host read of a device value (.item())"
        elif o["ins"] and o["outs"] and o["ins"][0][3] == "cuda" and \
                o["outs"][0][3] == "cpu":
            what = "a copy to the host"
        else:
            continue
        out.append(_hit(
            "GL021", short,
            "host round-trip (%s) inside a %s program: every dispatch "
            "waits for the card" % (what, tier), o["op"],
            sum(_nbytes(d) for d in o["ins"])))
    return out


def _rule_gl023(prog, tier):
    out = []
    for o in prog.ops:
        short = _short(o["op"])
        if not o["ins"] or not o["outs"]:
            continue
        src, dst = o["ins"][0], o["outs"][0]
        if short in ("repeat", "repeat_interleave", "expand_copy"):
            src_bytes = _nbytes(src)
        elif short in ("clone", "contiguous", "_to_copy", "copy_", "copy") \
                and len(src) > 4 and src[4]:
            src_bytes = src[5] * itemsize(src[2]) if len(src) > 5 else 0
        else:
            continue
        dst_bytes = _nbytes(dst)
        if src_bytes >= BCAST_MIN_IN and dst_bytes >= BCAST_MIN_OUT and \
                dst_bytes >= BCAST_FACTOR * src_bytes:
            out.append(_hit(
                "GL023", "%s:%s->%s" % (short, list(src[1]), list(dst[1])),
                "%s materializes a broadcast of %d bytes into %d (%dx): "
                "let the consumer broadcast instead of copying"
                % (short, src_bytes, dst_bytes, dst_bytes // src_bytes),
                o["op"], dst_bytes))
    return out


def _rule_gl024(prog, tier):
    out = []
    for at, o in enumerate(prog.ops):
        cv = _convert(o)
        if cv is None:
            continue
        src, dst = cv
        if itemsize(dst[2]) >= itemsize(src[2]):
            continue  # only a narrowing conversion starts a churn

        def widens(u, floor=itemsize(src[2])):
            c = _convert(u)
            return c is not None and itemsize(c[1][2]) >= floor

        i = prog.reach(dst[0], at, widens)
        if i is not None:
            back = _convert(prog.ops[i])[1]
            out.append(_hit(
                "GL024", "%s->%s->%s" % (src[2], dst[2], back[2]),
                "convert churn: a %s value narrowed to %s is widened back "
                "to %s with no compute between: keep the value before the "
                "narrowing for the read instead of paying both conversions"
                % (src[2], dst[2], back[2]), prog.ops[i]["op"],
                _nbytes(back)))
    return out


def _rule_gl025(prog, tier):
    out = []
    first = {}
    for i, vid in enumerate(prog.results):
        if vid in first:
            out.append(_hit("GL025", "out%d" % i,
                            "output %d duplicates output %d: the caller "
                            "gets the same tensor twice" % (i, first[vid])))
        else:
            first[vid] = i
        if vid.startswith("arg"):
            out.append(_hit("GL025", "out%d" % i,
                            "output %d returns an input untouched: the "
                            "caller holds it already" % i))
    return out


_RULE_FNS = (_rule_gl020, _rule_gl021, _rule_gl023, _rule_gl024,
             _rule_gl025)


def lint_record(ops, tier="", hint="", pkey="", cost=None):
    """Lint one program's op record. ``cost``: its ledger row
    (``costs.profiles()``'s), for the ranking."""
    prog = Program(ops)
    cost = cost or {}
    cb = float(cost.get("bytes") or 0.0)
    cf = float(cost.get("flops") or 0.0)
    best = {}
    for fn in _RULE_FNS:
        for h in fn(prog, tier):
            f = Finding(h["rule"], tier, hint, pkey, h["scope"], h["msg"],
                        h["op"], "", h["nbytes"], cb, cf)
            prev = best.get((f.rule, f.scope))
            if prev is None or f.nbytes > prev.nbytes:
                best[(f.rule, f.scope)] = f
    return rank(best.values())


def rank(findings):
    """Deterministic cost ranking: the program's bytes first, then the
    finding's own byte count, then the identity columns."""
    return sorted(findings,
                  key=lambda f: (-f.cost_bytes, -f.nbytes, f.tier, f.hint,
                                 f.rule, f.scope, f.msg))


def lint_corpus(profiles=None):
    """Lint every program ``observability.costs`` counted."""
    from ..observability import costs

    profiles = costs.profiles() if profiles is None else profiles
    out = []
    for (tier, key), (hint, ops) in sorted(costs.records().items()):
        out.extend(lint_record(ops, tier=tier, hint=hint, pkey=key,
                               cost=profiles.get("%s:%s" % (tier, key))))
    return rank(out)


def load_allowlist(path, section="hlolint"):
    """The ``section`` list of a committed allowlist file (``[{"id":
    finding key, "why": non-empty}]``) -> {id: why}. An entry without a
    why is an error."""
    with open(path) as fh:
        entries = json.load(fh)
    if isinstance(entries, dict):
        entries = entries.get(section, [])
    out = {}
    for e in entries:
        fid = e.get("id", "").strip()
        why = e.get("why", "").strip()
        if not fid:
            raise ValueError("hlolint allowlist entry without an id: %r" % e)
        if not why:
            raise ValueError("hlolint allowlist entry %r lacks a why: "
                             "every suppression is justified" % fid)
        out[fid] = why
    return out


def split_allowed(findings, allow):
    """(kept, suppressed, stale ids)."""
    kept, suppressed, hit = [], [], set()
    for f in findings:
        if f.key in allow:
            suppressed.append(f)
            hit.add(f.key)
        else:
            kept.append(f)
    return kept, suppressed, sorted(set(allow) - hit)


def snapshot_section(top=20):
    """The ``snapshot()["hlolint"]`` section: ranked, bounded, JSON-able."""
    from ..observability import costs

    findings = lint_corpus() if _enabled else []
    counts = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {"enabled": _enabled, "programs": len(costs.records()),
            "findings": [f.as_dict() for f in findings[:top]],
            "total_findings": len(findings), "counts": counts}


def enabled():
    return _enabled


def set_enabled(on=True):
    """The kill switch (also ``MXNET_HLOLINT=0`` at import). Returns the
    previous state."""
    global _enabled
    with _lock:
        prev = _enabled
        _enabled = bool(on)
    return prev
