"""``mx.nd`` op parity for A.17's contrib ops (``ops/contrib_extra.py``:
the utility, box-coder, FFT, quantization and interleaved attention ops,
``gradientmultiplier``'s scaled gradient), the CTC loss's ``nd`` names
(``ops/ctc.py``) and the sparse dot ``_csr_dot``: each case of
``tools/nd_op_cases.py`` from ``arange_like`` on, against the JAX
package's, with the tolerance the case states (fp32 1e-5 relative, 1e-6
absolute; 1e-4, 1e-5 for the FFTs and the CTC recursion)."""
import pytest

from torch_port_helpers import jax_trace_state, few_threads  # noqa: F401
from torch_port_nd_parity import cases_between, cases_param, check_parity

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

CONTRIB = cases_between("arange_like", None)


@cases_param(CONTRIB)
def test_nd_op_matches_jax(case, jax_trace_state):  # noqa: F811
    check_parity(case)
