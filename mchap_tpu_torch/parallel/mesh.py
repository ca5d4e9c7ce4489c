"""Spread the torch calling sampler over devices, with pooled allele counts.

Port of ``mchap_tpu/parallel/mesh.py``.  The reference scales by forking
one process per locus block (baseclass.py:360-394) and pools population
statistics in the parent.  Here a batch of padded (locus, sample)
problems is split over a list of devices (``parallel.sharding``); each
runs the batched calling sampler (``ops/calling_mcmc.py``) on its shard,
and the population allele counts, JAX's ``psum`` over the mesh, are
summed on the first device and across processes.
"""

import numpy as np
import torch

from mchap_tpu_torch.ops import calling_mcmc as _kernel
from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik
from mchap_tpu_torch.parallel import distributed as _dist
from mchap_tpu_torch.parallel.sharding import run_sharded
from mchap_tpu_torch.utils.seeds import shard_seed


def sharded_calling_step(devices, *, n_steps, ploidy, step_type=0, prior_kind=0):
    """The multi-device calling step over ``devices`` (a list).

    Returns fn(seed, initial [B, C, ploidy], read_hap [B, R, H],
    read_counts [B, R]) -> (genotypes [B, C, n_steps, ploidy], llks [B,
    C, n_steps], allele_counts [H]): the problem batch B is split over
    the devices (and ranks), each shard drawing from a generator seeded
    with ``shard_seed(seed, first problem)``; genotypes and llks come back
    as host arrays in problem order, and ``allele_counts`` is the
    population-pooled count of each allele over every shard's trace, a
    tensor on the first device.
    """

    def step(seed, initial, read_hap, read_counts):
        initial = torch.as_tensor(initial)
        read_hap = torch.as_tensor(read_hap, dtype=torch.float64)
        read_counts = torch.as_tensor(read_counts, dtype=torch.float64)
        n_problems, _, n_alleles = read_hap.shape
        total = torch.zeros(n_alleles, dtype=torch.float64, device=devices[0])

        def launch(sh):
            gen = torch.Generator(device=sh.device)
            gen.manual_seed(shard_seed(seed, sh.start))
            genotypes, llks = _kernel.calling_sampler(
                gen, *sh.arrays, n_steps=n_steps, step_type=step_type,
                prior_kind=prior_kind,
            )
            # a fixed-size scatter: bincount on a card waits for it
            flat = genotypes.reshape(-1)
            counts = torch.zeros(n_alleles, dtype=torch.float64, device=sh.device)
            counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float64))
            total.add_(counts.to(devices[0]))
            return genotypes, llks

        def fetch(sh, run):
            return list(zip(run[0].cpu().numpy(), run[1].cpu().numpy()))

        results = run_sharded(n_problems, (initial, read_hap, read_counts), launch, fetch,
                              devices=devices, device=devices[0], stage="device.sampler")
        genotypes = np.stack([g for g, _ in results])
        llks = np.stack([x for _, x in results])
        return genotypes, llks, _dist.all_reduce_sum(total)

    return step


def make_problem_batch(rng, n_problems, n_chains, ploidy, n_reads, n_pos, n_haps,
                       dtype=np.float32):
    """Synthetic padded problem batch for scale tests and benches:
    (initial int64[B, C, P], read_hap [B, R, H], read_counts [B, R]) as
    tensors, from numpy's ``rng``."""
    haplotypes = rng.integers(0, 2, size=(n_haps, n_pos)).astype(np.int8)
    truth = rng.integers(0, n_haps, size=(n_problems, ploidy))
    read_sources = haplotypes[truth[:, rng.integers(0, ploidy, size=n_reads)]]  # [B, R, n_pos]
    p_correct = 0.99
    onehot = read_sources[..., None] == np.arange(2)
    reads = np.where(onehot, p_correct, 1 - p_correct).astype(dtype)
    torch_dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    log_reads = prepare_reads(reads, dtype=torch_dtype)
    read_hap = read_hap_loglik(log_reads, haplotypes)  # [B, R, H]
    read_counts = torch.ones((n_problems, n_reads), dtype=torch_dtype)
    initial = torch.zeros((n_problems, n_chains, ploidy), dtype=torch.int64)
    return initial, read_hap, read_counts
