"""The mixed bases against the JAX package on the CPU, second half:
test_torch_mixed_bases.py's render test on the cases it leaves to this
file (``SPLIT_OFF``: the streamed-tier meshes, resident or DMA, the
static tier's UV mesh, dispersive glass and planar maps), so that two
workers share the renders. The scenes, the gates and JAX's large-table
forms are that file's.
"""

import pytest

from test_torch_mesh_tiers import force_dma  # noqa: F401 (a fixture)
from test_torch_mixed_bases import (  # noqa: F401 (an autouse fixture)
    CASES, SPLIT_OFF, check_mixed_base_vs_xla, jax_large_table_forms,
)
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)


def test_split_off_cases_are_cases():
    assert set(SPLIT_OFF) < set(CASES)


@pytest.mark.parametrize("case", SPLIT_OFF)
def test_mixed_base_vs_xla(request, case):
    """Tables bit-equal to JAX's, the variant, and the plain version's
    render against JAX's XLA driver under the golden gates."""
    check_mixed_base_vs_xla(request, case)
