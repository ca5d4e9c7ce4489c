"""PedigreeCallingMCMC: joint pedigree-informed genotype calling.

Port of ``mchap_tpu/models/pedigree.py`` (reference
``mchap/pedigree/classes.py``).  The route is chosen from the
configuration before any device work, with no fallback:

- K3 (``ops/cuda_pedigree.py``: the CUDA kernel on a card, its plain
  PyTorch version on the CPU) for Gibbs steps without double reduction
  whose two-parent samples' gamete ploidies sum to their ploidy, the
  reference defaults;
- the torch joint sampler (``ops/pedigree_mcmc.py``) otherwise: lambda >
  0, Metropolis-Hastings steps, other gamete ploidies.

Every locus of a block shares the pedigree, so all (locus, chain) chains
run in one launch.  Chains start from the greedy genotype of each
(locus, sample).  ``utils/fallback.note_path("pedigree", ...)`` records
the route taken: ``cuda``, ``plain`` or ``torch``.
"""

from dataclasses import dataclass

import numpy as np
import torch

from mchap_tpu_torch.models.calling import GenotypeAllelesMultiTrace
from mchap_tpu_torch.ops import cuda_pedigree as _k3
from mchap_tpu_torch.ops import pedigree_mcmc as _kernel
from mchap_tpu_torch.ops.calling_mcmc import greedy_caller
from mchap_tpu_torch.ops.likelihood import MIN_LOG, prepare_reads, read_hap_loglik
from mchap_tpu_torch.utils import fallback as _fallback
from mchap_tpu_torch.utils import timing as _timing
from mchap_tpu_torch.utils.device import resolve_device

# reference pedigree/classes.py:54-59
_STEP_TYPES = {"Gibbs": 0, "Metropolis-Hastings": 1}


def _assemble_problems_np(problems, h_max):
    """Per-problem read-hap matrices padded to a common [N, S, R, H] block
    (panel padding MIN_LOG, reads to a power-of-two bucket with count 0),
    plus counts, LINEAR frequency rows (padding 0) and panel sizes."""
    rh_list = [
        read_hap_loglik(prepare_reads(p["sample_reads"]), p["haplotypes"]).numpy()
        for p in problems
    ]
    max_r = max(rh.shape[1] for rh in rh_list)
    bucket = 8
    while bucket < max_r:
        bucket *= 2
    n_problems, n_samples = len(problems), rh_list[0].shape[0]
    rh_all = np.full((n_problems, n_samples, bucket, h_max), MIN_LOG)
    counts_all = np.zeros((n_problems, n_samples, bucket))
    freq_rows = np.zeros((n_problems, h_max))
    n_valid = np.zeros(n_problems, np.int32)
    for i, p in enumerate(problems):
        rh = rh_list[i]
        c = np.asarray(p["sample_read_counts"], float)
        h_i = rh.shape[-1]
        rh_all[i, :, : rh.shape[1], :h_i] = rh
        counts_all[i, :, : c.shape[1]] = c
        freqs = p.get("frequencies")
        if freqs is None:
            freqs = np.full(h_i, 1.0 / h_i)
        freq_rows[i, :h_i] = freqs
        n_valid[i] = h_i
    return rh_all, counts_all, freq_rows, n_valid


def _sort_roll_trace(trace, sample_ploidy, max_ploidy):
    """Sort each genotype, rolling the -1 padding of lower-ploidy samples
    to the end (reference mcmc.py:807-813)."""
    trace = np.sort(trace, axis=-1)
    for j in range(len(sample_ploidy)):
        ploidy = int(sample_ploidy[j])
        if ploidy < max_ploidy:
            trace[..., j, :] = np.roll(trace[..., j, :], ploidy - max_ploidy, axis=-1)
    return trace


def _greedy_initial(rh, counts, n_valid, sample_ploidy, max_ploidy):
    """Greedy genotype of every (problem, sample) at max_ploidy, with the
    slots beyond each sample's ploidy set to -1: [N, S, maxp]."""
    N, S, R, H = rh.shape
    g = greedy_caller(
        rh.reshape(N * S, R, H), counts.reshape(N * S, R), ploidy=max_ploidy,
        n_valid=n_valid.repeat_interleave(S),
    ).reshape(N, S, max_ploidy)
    slot = torch.arange(max_ploidy, device=rh.device)
    ploidy = torch.as_tensor(np.asarray(sample_ploidy), device=rh.device)
    return torch.where(slot[None, None, :] < ploidy[None, :, None], g, -1)


def _fit(problems, sample_ploidy, sample_parents, gamete_tau, gamete_lambda,
         gamete_error, steps, chains, seed, step_type, swap_parental_alleles,
         burn, device, initial=None):
    """All (problem, chain) chains through one sampler run; returns the
    sorted trace int16[N, chains, steps - burn, S, maxp] and n_valid."""
    if step_type not in _STEP_TYPES:
        raise ValueError('MCMC step type must be "Gibbs" or "Metropolis-Hastings"')
    device = resolve_device(device)
    sample_ploidy = np.asarray(sample_ploidy)
    max_ploidy = int(sample_ploidy.max())
    h_max = max(len(p["haplotypes"]) for p in problems)
    rh_np, counts_np, freq_np, nv_np = _assemble_problems_np(problems, h_max)
    N, S = rh_np.shape[:2]
    rh = torch.as_tensor(rh_np, device=device)
    counts = torch.as_tensor(counts_np, device=device)
    n_valid = torch.as_tensor(nv_np, device=device)
    if initial is None:
        init = _greedy_initial(rh, counts, n_valid, sample_ploidy, max_ploidy)
    else:
        init = torch.as_tensor(np.asarray(initial, np.int64), device=device)
        init = init.expand(N, S, max_ploidy)
    problem = torch.arange(N, dtype=torch.int32, device=device).repeat_interleave(chains)
    init = init.repeat_interleave(chains, dim=0).to(torch.int32).contiguous()

    reason = _k3.k3_unsupported_reason(
        sample_ploidy, sample_parents, gamete_tau, gamete_lambda, step_type
    )
    if reason is None:
        plan = _k3.Plan(sample_ploidy, sample_parents, gamete_tau, gamete_lambda,
                        gamete_error, swap_parental_alleles=swap_parental_alleles)
        with _timing.stage("device.kernel"):
            trace = _k3.pedigree_sampler(
                rh.float().contiguous(), counts.float().contiguous(),
                torch.as_tensor(freq_np, device=device), n_valid, problem, init,
                plan, n_steps=steps, seed=seed,
            )
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        _fallback.note_path("pedigree", "cuda" if device.type == "cuda" else "plain")
    else:
        ped = _kernel.Pedigree(sample_ploidy, sample_parents, gamete_tau,
                               gamete_lambda, gamete_error, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        with np.errstate(divide="ignore"):
            log_freqs = torch.as_tensor(np.log(freq_np), device=device)
        with _timing.stage("device.sampler"):
            trace = _kernel.pedigree_sampler(
                gen, init, rh, counts, log_freqs, n_valid, problem, ped,
                n_steps=steps, step_type=_STEP_TYPES[step_type],
                swap_parental_alleles=swap_parental_alleles,
            )
        _fallback.note_path("pedigree", "torch")
    with _timing.stage("device.trace_fetch"):
        trace = trace[:, burn:].to(torch.int16).cpu().numpy()
    trace = trace.reshape((N, chains) + trace.shape[1:])
    return _sort_roll_trace(trace, sample_ploidy, max_ploidy), nv_np


@dataclass
class PedigreeCallingMCMC:
    """Joint MCMC over all samples in a pedigree.

    Attributes mirror reference pedigree/classes.py:14-28; ``device`` is
    ``"cuda"`` (the default; raises without a card) or ``"cpu"``.
    """

    sample_ploidy: np.ndarray
    sample_parents: np.ndarray
    gamete_tau: np.ndarray
    gamete_lambda: np.ndarray
    gamete_error: np.ndarray
    haplotypes: np.ndarray
    frequencies: np.ndarray = None
    steps: int = 2000
    annealing: int = 1000  # accepted for API parity; the reference
    # computes but never applies the annealing weights (mcmc.py:738-740)
    chains: int = 2
    random_seed: int = None
    step_type: str = "Gibbs"
    swap_parental_alleles: bool = True
    device: str = "cuda"

    def fit(self, sample_reads, sample_read_counts, initial=None):
        """Run ``chains`` joint chains; returns a pedigree trace.

        sample_reads: float[n_samples, max_reads, n_pos, max_nucl]
        (padded with nan reads); sample_read_counts: int[n_samples,
        max_reads] (0 marks padding).  ``initial`` i[n_samples,
        max_ploidy] starts every chain there (default: greedy).
        """
        problem = dict(
            sample_reads=sample_reads, sample_read_counts=sample_read_counts,
            haplotypes=np.asarray(self.haplotypes), frequencies=self.frequencies,
        )
        seed = self.random_seed if self.random_seed is not None else 0
        trace, nv = _fit(
            [problem], self.sample_ploidy, self.sample_parents, self.gamete_tau,
            self.gamete_lambda, self.gamete_error, self.steps, self.chains, seed,
            self.step_type, self.swap_parental_alleles, 0, self.device,
            initial=initial,
        )
        return PedigreeAllelesMultiTrace(trace[0], n_allele=int(nv[0]))


def fit_pedigree_multi(
    problems,
    sample_ploidy,
    sample_parents,
    gamete_tau,
    gamete_lambda,
    gamete_error,
    steps=2000,
    chains=1,
    random_seed=None,
    step_type="Gibbs",
    swap_parental_alleles=True,
    burn=0,
    device=None,
):
    """Fit the pedigree sampler for MANY LOCI of the same pedigree at once.

    ``problems``: list of dicts with keys ``sample_reads`` (f[S, R_i,
    P_i, N_i]), ``sample_read_counts`` (i[S, R_i]), ``haplotypes``
    (i[H_i, P_i]) and optionally ``frequencies`` (f[H_i]).  Panels are
    padded to the block's largest with MIN_LOG read-hap columns and zero
    frequency (never drawn: ``n_valid``), reads to a power-of-two bucket.
    Burn-in is sliced on the device.  Returns one
    PedigreeAllelesMultiTrace per problem.
    """
    seed = random_seed if random_seed is not None else 0
    trace, nv = _fit(
        problems, sample_ploidy, sample_parents, gamete_tau, gamete_lambda,
        gamete_error, steps, chains, seed, step_type, swap_parental_alleles,
        burn, device,
    )
    return [
        PedigreeAllelesMultiTrace(trace[i], n_allele=int(nv[i]), pre_burned=burn)
        for i in range(len(problems))
    ]


@dataclass
class PedigreeAllelesMultiTrace:
    """Joint trace over all pedigree samples; reference classes.py:137-161."""

    genotypes: np.ndarray  # [chains, steps, n_samples, max_ploidy]
    n_allele: int
    pre_burned: int = 0  # steps already dropped on the device

    def burn(self, n):
        """Drop the first ``n`` steps of the ORIGINAL trace (a no-op for
        steps the device already sliced, see ``pre_burned``)."""
        k = max(n - self.pre_burned, 0)
        return type(self)(
            self.genotypes[:, k:],
            n_allele=self.n_allele,
            pre_burned=max(n, self.pre_burned),
        )

    def individual(self, index):
        """Per-sample GenotypeAllelesMultiTrace (padding stripped)."""
        sample_trace = self.genotypes[:, :, index, :]
        ploidy = int((sample_trace[0, 0] >= 0).sum())
        return GenotypeAllelesMultiTrace(
            sample_trace[:, :, 0:ploidy],
            np.full(self.genotypes.shape[0:2], np.nan),
            self.n_allele,
        )

    def incongruence(self, sample_ploidy, sample_parents, gamete_tau, gamete_lambda):
        """Per-sample rate of pedigree-incompatible states (PEDERR).

        Vectorized equivalent of reference ``_trace_incongruence``
        (classes.py:91-134).
        """
        trace = self.genotypes
        n_chains, n_steps, n_samples, max_ploidy = trace.shape
        trace = trace.reshape(n_chains * n_steps, n_samples, max_ploidy)
        sample_parents = np.asarray(sample_parents)
        out = np.zeros(n_samples)
        for i in range(n_samples):
            p, q = sample_parents[i]
            progeny = trace[:, i, :]
            if p < 0 and q < 0:
                continue
            if p < 0:
                valid = _kernel.duo_valid(
                    progeny, trace[:, q, :], gamete_tau[i, 1], gamete_lambda[i, 1]
                )
            elif q < 0:
                valid = _kernel.duo_valid(
                    progeny, trace[:, p, :], gamete_tau[i, 0], gamete_lambda[i, 0]
                )
            else:
                valid = _kernel.trio_valid(
                    progeny,
                    trace[:, p, :],
                    trace[:, q, :],
                    gamete_tau[i, 0],
                    gamete_tau[i, 1],
                    gamete_lambda[i, 0],
                    gamete_lambda[i, 1],
                )
            out[i] = 1.0 - valid.mean()
        return out
