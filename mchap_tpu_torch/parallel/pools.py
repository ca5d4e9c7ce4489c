"""Population INFO-field reductions over a sharded problem batch.

Port of ``mchap_tpu/parallel/pools.py``.  The reference pools per-sample
posterior summaries into population INFO fields in the parent process
(mchap/application/baseclass.py:245-301): sums for ACP/AOPSUM/SNVDP and
a product of complements for AOP (1 - prod(1 - p) over samples).  When
a block's (locus, sample) problems are spread over devices and
processes (``parallel.sharding``), one locus's samples can sit in
different shards, so each shard takes per-locus segment sums
(``index_add_``), the shards are summed on the first device and across
processes with ``all_reduce``.  AOP's product becomes a sum of
``log1p(-p)``, mapped back through ``1 - exp``.  No padding: a shard
holds only real problems.

The CLI keeps its host-side pooling (per-sample summaries are tiny and
already on the host after tabulation); this module is the library form,
held against the host formulas and JAX's collectives in the tests.
"""

import torch

from mchap_tpu_torch.parallel import distributed as _dist
from mchap_tpu_torch.parallel.sharding import shard_problems


def pooled_info(devices, n_loci, locus_ids, acp, aop, snvdp):
    """Pool per-problem summaries into per-locus INFO fields.

    ``locus_ids`` [B] (each problem's locus, in [0, n_loci)), ``acp``,
    ``aop``, ``snvdp`` [B, K]; B problems spread over ``devices`` (a
    list, as ``sharding.problem_devices`` gives; None: the CPU).
    Returns f64 (ACP, AOPSUM, AOP, SNVDP), each [n_loci, K], on the
    first device, pooled over every shard of every rank.
    """
    devices = devices or [torch.device("cpu")]
    ids = torch.as_tensor(locus_ids, dtype=torch.long)
    values = [torch.as_tensor(x, dtype=torch.float64) for x in (acp, aop, snvdp)]
    k = values[0].shape[1]
    total = torch.zeros((4, n_loci, k), dtype=torch.float64, device=devices[0])
    for sh in shard_problems(devices, len(ids), ids, *values):
        ids_s, acp_s, aop_s, snvdp_s = sh.arrays
        local = torch.zeros((4, n_loci, k), dtype=torch.float64, device=sh.device)
        local[0].index_add_(0, ids_s, acp_s)
        local[1].index_add_(0, ids_s, aop_s)
        local[2].index_add_(0, ids_s, torch.log1p(-aop_s.clamp(0.0, 1.0 - 1e-12)))
        local[3].index_add_(0, ids_s, snvdp_s)
        total += local.to(devices[0])
    total = _dist.all_reduce_sum(total)
    return total[0], total[1], 1.0 - torch.exp(total[2]), total[3]
