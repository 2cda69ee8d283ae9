"""Static and run-time hygiene analysis of the port (counterpart of
``mxnet_tpu/analysis``), the JAX package's rule IDs retargeted to torch:

* :mod:`.graphlint` (stage 1): an AST linter of the port's Python for the
  hazards that break a captured hot path, GL001-GL017 (``RULES``; GL005 is
  ``NOT_APPLICABLE``). The tier-1 suite runs it over
  ``mxnet_tpu_torch/`` against ``tools/torch_graphlint_allow.json``.
* :mod:`.validate` (stage 2): :func:`check_hybridizable` and
  ``HybridBlock.hybridize(validate=True)`` run a block and prove what
  stage 1 suspects: a host read during the forward (GL101), two runs at one
  signature that differ (GL102), a parameter that reaches no output
  (GL103), control flow on the inputs' values (GL104).
* :mod:`.concurrency` (racecheck): static GL011-GL015 over the threading
  layers, and the run-time lock-order and race check under
  ``MXNET_LOCK_CHECK=1``.
* :mod:`.hlolint`: the program lint, GL020+, over the op records
  ``observability.costs`` keeps of every program (the port has no
  StableHLO text; the record is what the JAX package's lint reads there).
"""
from . import concurrency  # noqa: F401  (stdlib only; also GL011-GL015)
from . import hlolint  # noqa: F401
from .graphlint import (NOT_APPLICABLE, RULES, Finding,  # noqa: F401
                        format_findings, lint_paths, lint_source,
                        load_allowlist, split_allowed)
from .validate import GraphlintError, check_hybridizable  # noqa: F401

__all__ = ["Finding", "RULES", "NOT_APPLICABLE", "lint_paths",
           "lint_source", "load_allowlist", "split_allowed",
           "format_findings", "GraphlintError", "check_hybridizable",
           "concurrency", "hlolint"]
