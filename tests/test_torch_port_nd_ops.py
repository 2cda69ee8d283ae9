"""``mx.nd`` op parity, the elementwise families of ``tools/nd_op_cases.py``
(one and two inputs, python scalars, integer inputs, comparisons): each op
of the port against the JAX package's on the same seeded inputs, forward
and gradient; fp32 within 1e-5 relative and 1e-6 absolute (1e-4 and 1e-5
for the special functions), integer outputs exact, dtypes equal."""
import pytest

from torch_port_helpers import jax_trace_state, few_threads  # noqa: F401
from torch_port_nd_parity import cases_between, cases_param, check_parity

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

ELEMENTWISE = cases_between(None, "sum")


@cases_param(ELEMENTWISE)
def test_nd_op_matches_jax(case, jax_trace_state):  # noqa: F811
    check_parity(case)
