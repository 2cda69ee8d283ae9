"""``mx.nd`` op parity for the KV-cache writes, the fused recurrence and
the detection ops of ``tools/nd_op_cases.py``: each op of the port against
the JAX package's on the same seeded inputs, forward and gradient, at the
tolerances of ``test_torch_port_nd_ops.py`` (fp32 1e-5 relative, 1e-6
absolute; integer outputs exact). Through ``nd`` the cache writes leave
the cache they are given as it was, as the JAX package's functional ops
do (``check_parity`` holds every case's inputs to that)."""
import pytest

from torch_port_helpers import jax_trace_state, few_threads  # noqa: F401
from torch_port_nd_parity import cases_between, cases_param, check_parity

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

A11 = cases_between("cache_write", "all_finite")


@cases_param(A11)
def test_nd_op_matches_jax(case, jax_trace_state):  # noqa: F811
    check_parity(case)
