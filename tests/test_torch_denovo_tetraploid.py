"""K1 parity with the JAX kernel in interpret mode at ploidy 4.

See test_torch_denovo.py; the tetraploid cases live in their own file
because the JAX interpreter takes most of a minute over them.
"""

import pytest
import torch

from test_torch_fixtures import k1_compare_with_pallas

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("A", [2, 4])
def test_plain_matches_pallas_interpret_tetraploid(A, stage):
    k1_compare_with_pallas(4, A, stage)
