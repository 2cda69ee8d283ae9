"""``mx.nd`` op parity for the nn layers and the output heads with their
own backwards of ``tools/nd_op_cases.py``: each op of the port against the
JAX package's on the same seeded inputs, forward and gradient, at the
tolerances of ``test_torch_port_nd_ops.py``."""
import pytest

from torch_port_helpers import jax_trace_state, few_threads  # noqa: F401
from torch_port_nd_parity import cases_between, cases_param, check_parity

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

NN = cases_between("FullyConnected", "cache_write")


@cases_param(NN)
def test_nd_op_matches_jax(case, jax_trace_state):  # noqa: F811
    check_parity(case)
