"""K1 above ploidy 8 against the JAX kernel: with its noise pinned at
1e-12, the port's plain version retraces
``pallas_denovo_sampler(..., interpret=True)`` at ploidy 9, stage 3
(identical packed traces, llks within 1e-4).
"""

import torch

from test_torch_fixtures import k1_compare_with_pallas

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)


def test_plain_matches_pallas_interpret_ploidy9():
    """About 150 s on one core, nearly all of it the JAX interpreter's
    compile of the kernel's 36 recombination and 72 dosage options at
    ploidy 9; three positions and one step keep the rest small."""
    k1_compare_with_pallas(9, 2, 3, n_steps=1, NB=3)
