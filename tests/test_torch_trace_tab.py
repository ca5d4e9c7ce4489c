"""Trace tabulation: the port's torch version against the JAX one.

Every output must be equal: the distinct states, multiplicities,
first-seen indices (the tie-break order of the posterior), the
distinct-state count that flags overflow, and each state's llk.
"""

import numpy as np
import pytest
import torch

from mchap_tpu.ops.trace_tab import tabulate_packed_trace as jax_tabulate
from mchap_tpu_torch.ops.trace_tab import tabulate_packed_trace

# These tests run many small torch ops: beside the test runner's
# parallel workers, torch's own thread pool only contends for the cores.
torch.set_num_threads(1)


def _trace(rng, steps, ploidy, nb, lanes, n_alleles, base, n_states):
    """A packed trace revisiting a small state pool with shuffled rows."""
    pool = rng.integers(0, n_alleles, size=(n_states, ploidy, nb))
    pick = rng.integers(0, n_states, size=(steps, lanes))
    packed = np.zeros((steps, nb, lanes), np.int32)
    for s in range(steps):
        for lane in range(lanes):
            g = pool[pick[s, lane]][rng.permutation(ploidy)]
            packed[s, :, lane] = (g * base ** np.arange(ploidy)[:, None]).sum(0)
    return packed


@pytest.mark.parametrize(
    "ploidy,nb,n_alleles,steps,lanes,n_states,n_cap,burn,with_llks",
    [
        (2, 3, 2, 17, 4, 5, 17, 0, True),
        (4, 5, 3, 40, 8, 6, 40, 7, True),
        (4, 23, 2, 30, 4, 5, 30, 3, False),  # multi-word sort keys
        (2, 33, 4, 20, 2, 4, 20, 0, True),
        (4, 8, 2, 40, 6, 12, 5, 4, True),  # more distinct states than n_cap
        (6, 2, 2, 25, 4, 5, 25, 0, False),
    ],
)
def test_tabulate_matches_jax(ploidy, nb, n_alleles, steps, lanes, n_states,
                              n_cap, burn, with_llks):
    rng = np.random.default_rng(ploidy * 100 + nb)
    base = 1
    while base < max(n_alleles, 2):
        base *= 2
    packed = _trace(rng, steps, ploidy, nb, lanes, n_alleles, base, n_states)
    llks = rng.normal(size=(steps, lanes)).astype(np.float32) if with_llks else None
    kw = dict(ploidy=ploidy, base=base, n_cap=n_cap, burn=burn)
    want = jax_tabulate(packed, llks, **kw)
    got = tabulate_packed_trace(
        torch.from_numpy(packed),
        None if llks is None else torch.from_numpy(llks),
        **kw,
    )
    assert len(got) == len(want) == (5 if with_llks else 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if n_cap < n_states:
        assert (got[3] > n_cap).any()  # the overflow flag is exercised
