"""``tools/nd_op_cases.py``'s cases on both packages: each case's op
through ``mx.nd`` of the JAX package and of the port, on the same seeded
inputs, forward and (where the case asks) the gradient of sum(out * w)
with respect to its float inputs."""
import pytest

from tools.nd_op_cases import (CASES, assert_inputs_kept, assert_same,
                               run_case)


def check_parity(case):
    """The port's op against the JAX package's, on the CPU; and the port's
    op leaves its inputs as they were, unless it writes them by design."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    with tmx.cpu():
        t = run_case(tmx.nd, tmx.autograd, case,
                     lambda x: tmx.nd.array(x, dtype=x.dtype.name))
    j = run_case(jmx.nd, jmx.autograd, case,
                 lambda x: jmx.nd.array(x, dtype=x.dtype.name))
    for got, want, what in zip(t, j, ("output", "input after", "grad")):
        assert_same(got, want, case.tol, "%s %s" % (case.id, what))
    assert_inputs_kept(case, t[1])


def cases_param(cases):
    return pytest.mark.parametrize("case", cases, ids=[c.id for c in cases])


def cases_between(first, stop):
    """The cases from id ``first`` up to id ``stop`` (None: an end)."""
    ids = [c.id for c in CASES]
    return CASES[ids.index(first) if first else 0:
                 ids.index(stop) if stop else len(CASES)]
