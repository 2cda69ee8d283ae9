"""The two deepest families of the port's vision zoo against the JAX
package's: densenet121 and inceptionv3, inference logits within 1e-5 of
the largest (see ``test_torch_port_model_zoo.py``)."""
import pytest

from test_torch_port_model_zoo import family_forward_matches_jax
from torch_port_helpers import jax_trace_state  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("name,size", [("densenet121", 32),
                                       ("inceptionv3", 299)])
def test_deep_family_forward_matches_jax(jax_trace_state,  # noqa: F811
                                         name, size):
    family_forward_matches_jax(name, size)
