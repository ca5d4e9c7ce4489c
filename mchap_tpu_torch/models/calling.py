"""CallingMCMC model: known-haplotype genotype calling by batched MCMC.

Port of ``mchap_tpu/models/calling.py`` (reference
``mchap/calling/classes.py``).  Flat-prior Gibbs, the default of
``mchap call``, runs every (locus, sample) problem and its chains through
one launch of K2 (``ops/cuda_calling.py``): the CUDA kernel on a card,
its plain PyTorch version on the CPU.  A Dirichlet-multinomial prior, a
Metropolis-Hastings step, or a shape K2 does not take
(``k2_unsupported_reason``: ploidy above 8, too many reads) runs the
batched torch sampler (``ops/calling_mcmc.py``), chosen before any
launch.  Nothing falls back from one to the other: a failed launch
raises.  Posterior tabulation happens on the host on the
small kept trace.
"""

from dataclasses import dataclass

import numpy as np
import torch

from mchap_tpu_torch import mset
from mchap_tpu_torch.models.assemble import pad_reads_bucket
from mchap_tpu_torch.numerics.combinadics import (
    count_unique_genotypes,
    genotype_alleles_as_index,
)
from mchap_tpu_torch.ops import calling_mcmc as _mcmc
from mchap_tpu_torch.ops.cuda_calling import (
    allele_dtype,
    calling_sampler,
    k2_unsupported_reason,
)
from mchap_tpu_torch.ops.likelihood import MIN_LOG, prepare_reads, read_hap_loglik
from mchap_tpu_torch.parallel.sharding import run_sharded
from mchap_tpu_torch.utils import fallback as _fallback
from mchap_tpu_torch.utils import timing as _timing
from mchap_tpu_torch.utils.device import resolve_device
from mchap_tpu_torch.utils.seeds import shard_seed

_STEP_TYPES = {"Gibbs": 0, "Metropolis-Hastings": 1}


def _step_type(name):
    if name not in _STEP_TYPES:
        raise ValueError('MCMC step type must be "Gibbs" or "Metropolis-Hastings"')
    return _STEP_TYPES[name]


def _fit_batch_kernel(read_hap, counts, ploidy, steps, chains, seed, n_valid,
                      burn=0, *, device, pinned_noise=None, devices="auto"):
    """Run all problems x chains through K2, one launch per shard.

    read_hap [S, R, H] (cast to f32, as the JAX package does), counts
    [S, R], n_valid [S]: columns >= n_valid[i] of problem i are padding,
    and its trace is labelled with n_valid[i] alleles.  Chain
    ``i * chains + c`` is chain c of problem i; the reads stay per
    problem.  Every chain starts at allele 0 and sweeps its slots in
    order (valid sampler choices, gated by exact enumeration).  The
    problems are spread over ``devices`` (``parallel.sharding``; every
    shard at the block's H and read bucket, its draws keyed by global
    chain, so placement changes no result).  Burn-in is sliced on the
    device, so only kept steps are copied.  ``pinned_noise`` (a float)
    replaces every uniform draw (tests).
    """
    rh = torch.as_tensor(read_hap, dtype=torch.float32).contiguous()
    S, _, H = rh.shape
    counts_t = torch.as_tensor(counts, dtype=torch.float32).contiguous()
    n_valid = np.asarray(n_valid, np.int32)
    kept = steps - burn

    def launch(sh):
        n = sh.stop - sh.start
        problem = torch.arange(n, dtype=torch.int32, device=sh.device)
        noise = None
        if pinned_noise is not None:
            noise = torch.full(
                (steps, ploidy, H, n * chains), float(pinned_noise), device=sh.device
            )
        return calling_sampler(
            *sh.arrays, problem.repeat_interleave(chains), n_steps=steps,
            ploidy=ploidy, seed=seed, noise=noise, chain_offset=sh.start * chains,
        )

    def fetch(sh, run):
        n = sh.stop - sh.start
        with _timing.stage("device.trace_fetch"):
            alleles = run[0][burn:].cpu().numpy()
            llks = run[1][burn:].cpu().numpy()
        genotypes = alleles.reshape(kept, ploidy, n, chains).transpose(2, 3, 0, 1)
        llks = llks.reshape(kept, n, chains).transpose(1, 2, 0)
        return [
            GenotypeAllelesMultiTrace(
                genotypes[i], llks[i].astype(float), int(n_valid[sh.start + i]), burn
            )
            for i in range(n)
        ]

    traces = run_sharded(S, (rh, counts_t, torch.as_tensor(n_valid)), launch, fetch,
                         devices=devices, device=device, stage="device.kernel")
    _fallback.note_path("calling", "cuda" if device.type == "cuda" else "plain")
    return traces


def _fit_batch_torch(read_hap, counts, ploidy, steps, chains, seed, step_type,
                     inbreeding=None, frequencies=None, n_valid=None, burn=0, *,
                     device, initial=None, devices="auto"):
    """Run all problems x chains through the batched torch sampler.

    Initial genotypes are the greedy caller's unless ``initial``
    ([S, chains, ploidy]) is given.  The problems are spread over
    ``devices`` (``parallel.sharding``), each shard drawing from its own
    generator seeded with ``shard_seed(seed, first problem)``: a run is
    reproducible for its placement.  Returns one trace per problem.
    """
    rh = torch.as_tensor(read_hap, dtype=torch.float64).contiguous()
    S, _, H = rh.shape
    prior_kind = 0 if inbreeding is None else 1
    arrays = {
        "rh": rh,
        "counts": torch.as_tensor(counts, dtype=torch.float64).contiguous(),
        "inbreeding": torch.as_tensor(
            np.zeros(S) if inbreeding is None else np.asarray(inbreeding, float),
            dtype=torch.float64,
        ),
    }
    if frequencies is not None:
        arrays["freqs"] = torch.as_tensor(
            np.broadcast_to(np.asarray(frequencies, float), (S, H)).copy()
        )
    if n_valid is not None:
        arrays["nv"] = torch.as_tensor(np.asarray(n_valid))
    if initial is not None:
        arrays["initial"] = torch.as_tensor(np.ascontiguousarray(initial))
    n_alleles = [H] * S if n_valid is None else [int(n) for n in n_valid]

    def launch(sh):
        x = dict(zip(arrays, sh.arrays))
        freqs, nv = x.get("freqs"), x.get("nv")
        init = x.get("initial")
        if init is None:
            init = _mcmc.greedy_caller(
                x["rh"], x["counts"], ploidy=ploidy, prior_kind=prior_kind,
                inbreeding=x["inbreeding"], frequencies=freqs, n_valid=nv,
            )[:, None, :].expand(sh.stop - sh.start, chains, ploidy)
        gen = torch.Generator(device=sh.device)
        gen.manual_seed(shard_seed(seed, sh.start))
        return _mcmc.calling_sampler(
            gen, init, x["rh"], x["counts"], n_steps=steps, step_type=step_type,
            prior_kind=prior_kind, inbreeding=x["inbreeding"], frequencies=freqs,
            n_valid=nv,
        )

    def fetch(sh, run):
        genotypes = run[0][:, :, burn:].to(allele_dtype(H)).cpu().numpy()
        llks = run[1][:, :, burn:].cpu().numpy()
        return [
            GenotypeAllelesMultiTrace(genotypes[i], llks[i], n_alleles[sh.start + i], burn)
            for i in range(sh.stop - sh.start)
        ]

    traces = run_sharded(S, tuple(arrays.values()), launch, fetch, devices=devices,
                         device=device, stage="device.sampler")
    _fallback.note_path("calling", "torch")
    return traces


@dataclass
class CallingMCMC:
    """MCMC genotype caller over a known haplotype panel.

    Attributes mirror reference calling/classes.py:15-47; ``device`` is
    ``"cuda"`` (the default; raises without a card) or ``"cpu"``.
    """

    ploidy: int
    haplotypes: np.ndarray
    prior: tuple = None
    steps: int = 1000
    chains: int = 2
    random_seed: int = None
    step_type: str = "Gibbs"
    device: str = "cuda"

    def fit(self, reads, read_counts=None, initial=None):
        """Run ``chains`` batched MCMC chains; returns a multi-chain trace.

        Reference semantics: calling/classes.py:49-124 (zero-variant
        shortcut, per-step sorted genotypes).  Without ``initial`` this
        runs the batched core with one problem (K2 for flat-prior Gibbs,
        which starts every slot at allele 0; the torch sampler from the
        greedy genotype otherwise); with ``initial`` the torch sampler
        starts from it.
        """
        haplotypes = np.asarray(self.haplotypes)
        inbreeding, frequencies = (None, None) if self.prior is None else self.prior
        if initial is None:
            return fit_calling_batch(
                self.ploidy, haplotypes, [reads],
                [np.ones(len(reads)) if read_counts is None else read_counts],
                inbreeding_list=None if self.prior is None else [inbreeding],
                frequencies=frequencies, steps=self.steps, chains=self.chains,
                random_seed=self.random_seed, step_type=self.step_type,
                device=self.device,
            )[0]
        if reads.shape[1] == 0:
            return _zero_variant_traces(1, self.chains, self.steps, self.ploidy)[0]
        if read_counts is None:
            read_counts = np.ones(len(reads))
        read_hap = read_hap_loglik(prepare_reads(reads), haplotypes)[None]
        initial = np.broadcast_to(
            np.asarray(initial, np.int64), (1, self.chains, self.ploidy)
        )
        seed = self.random_seed if self.random_seed is not None else 0
        return _fit_batch_torch(
            read_hap, np.asarray(read_counts, float)[None], self.ploidy,
            self.steps, self.chains, seed, _step_type(self.step_type),
            inbreeding=None if self.prior is None else [inbreeding],
            frequencies=frequencies, device=resolve_device(self.device),
            initial=initial,
        )[0]


def _zero_variant_traces(n, chains, steps, ploidy):
    """Only the reference allele exists: constant traces, nan llks."""
    return [
        GenotypeAllelesMultiTrace(
            np.zeros((chains, steps, ploidy), np.int8),
            np.full((chains, steps), np.nan),
            1,
        )
        for _ in range(n)
    ]


def fit_calling_batch(
    ploidy,
    haplotypes,
    reads_list,
    counts_list,
    inbreeding_list=None,
    frequencies=None,
    steps=1000,
    chains=2,
    random_seed=None,
    step_type="Gibbs",
    burn=0,
    device=None,
    devices="auto",
):
    """Fit the calling sampler for MANY samples of one locus in one launch.

    The reference application runs one sampler per sample
    (call.py:120-199); here one read-hap product covers all samples and
    one launch all samples x chains (one per device of ``devices``,
    ``parallel.sharding.problem_devices``).  Returns one trace per
    sample.
    """
    haplotypes = np.asarray(haplotypes)
    n_alleles = len(haplotypes)
    n_samples = len(reads_list)
    step_type_i = _step_type(step_type)
    device = resolve_device(device)
    if reads_list[0].shape[1] == 0:
        assert n_alleles == 1
        return _zero_variant_traces(n_samples, chains, steps, ploidy)

    reads, counts = pad_reads_bucket(reads_list, counts_list)
    read_hap = read_hap_loglik(prepare_reads(reads), haplotypes)  # [S, R, H] f64
    seed = random_seed if random_seed is not None else 0
    if (inbreeding_list is None and step_type_i == 0
            and k2_unsupported_reason(ploidy, read_hap.shape[1]) is None):
        return _fit_batch_kernel(
            read_hap, counts, ploidy, steps, chains, seed,
            np.full(n_samples, n_alleles), burn=burn, device=device, devices=devices,
        )
    return _fit_batch_torch(
        read_hap, counts, ploidy, steps, chains, seed, step_type_i,
        inbreeding=inbreeding_list, frequencies=frequencies, burn=burn,
        device=device, devices=devices,
    )


def fit_calling_multi(
    problems,
    ploidy,
    steps=1000,
    chains=2,
    random_seed=None,
    step_type="Gibbs",
    burn=0,
    device=None,
    devices="auto",
):
    """Fit the calling sampler for problems spanning MANY LOCI at once.

    ``problems``: list of dicts with keys ``reads`` (f[R_i, P_i, A_i]),
    ``counts`` (f[R_i]), ``haplotypes`` (i[H_i, P_i]) and optionally
    ``inbreeding``/``frequencies``.  Panels are padded to the block's
    largest with impossible (MIN_LOG) columns that ``n_valid`` masks,
    reads to a power-of-two bucket with zero counts; one launch then
    samples every (locus, sample) chain, spread over ``devices``
    (``parallel.sharding.problem_devices``; ``"auto"``: every visible
    card, and a rank's share in a process group).  Returns one trace per
    problem, alleles indexed within each problem's own panel.
    """
    device = resolve_device(device)
    use_prior = any("inbreeding" in p for p in problems)
    h_max = max(len(p["haplotypes"]) for p in problems)
    step_type_i = _step_type(step_type)

    rh_list, counts_list, freq_rows, inbreeding_rows = [], [], [], []
    for p in problems:
        rh = read_hap_loglik(prepare_reads(p["reads"]), p["haplotypes"]).numpy()
        h_i = rh.shape[1]
        rh_list.append(np.pad(rh, ((0, 0), (0, h_max - h_i)), constant_values=MIN_LOG))
        counts_list.append(np.asarray(p["counts"], float))
        if use_prior:
            freqs = p.get("frequencies")
            if freqs is None:
                freqs = np.full(h_i, 1.0 / h_i)
            freq_rows.append(np.pad(np.asarray(freqs, float), (0, h_max - h_i)))
            inbreeding_rows.append(float(p.get("inbreeding", 0.0)))

    # Padded reads are 0 (not nan) with count 0: the sampler multiplies
    # each read's term by its count.
    read_hap, counts = pad_reads_bucket(rh_list, counts_list, fill=0.0)
    n_valid = np.array([len(p["haplotypes"]) for p in problems], np.int32)
    seed = random_seed if random_seed is not None else 0
    if (not use_prior and step_type_i == 0
            and k2_unsupported_reason(ploidy, read_hap.shape[1]) is None):
        return _fit_batch_kernel(
            read_hap, counts, ploidy, steps, chains, seed, n_valid, burn=burn,
            device=device, devices=devices,
        )
    return _fit_batch_torch(
        read_hap, counts, ploidy, steps, chains, seed, step_type_i,
        inbreeding=inbreeding_rows if use_prior else None,
        frequencies=np.stack(freq_rows) if use_prior else None,
        n_valid=n_valid, burn=burn, device=device, devices=devices,
    )


@dataclass
class GenotypeAllelesMultiTrace:
    """Multi-chain trace of allele-index genotypes.

    Reference: calling/classes.py:127-297.
    """

    genotypes: np.ndarray  # [n_chains, n_steps, ploidy]
    llks: np.ndarray  # [n_chains, n_steps]
    n_allele: int
    pre_burned: int = 0  # steps already dropped on the device

    def relabel(self, labels):
        """Map alleles through ``labels``; reference classes.py:147-165."""
        return type(self)(
            labels[self.genotypes], self.llks, labels.max() + 1, self.pre_burned
        )

    def burn(self, n):
        """Drop the first ``n`` steps of the ORIGINAL trace (a no-op for
        steps the device already sliced, see ``pre_burned``)."""
        k = max(n - self.pre_burned, 0)
        return type(self)(
            self.genotypes[:, k:],
            self.llks[:, k:],
            self.n_allele,
            max(n, self.pre_burned),
        )

    def posterior(self):
        """Posterior over unique genotypes (frequency in merged trace)."""
        n_chain, n_step = self.genotypes.shape[:2]
        flat = self.genotypes.reshape((n_chain * n_step,) + self.genotypes.shape[2:])
        states, counts = mset.unique_counts(flat)
        probs = counts / counts.sum()
        idx = np.flip(np.argsort(probs, kind="stable"))
        return PosteriorGenotypeAllelesDistribution(states[idx], probs[idx])

    def split(self):
        """Yield single-chain traces."""
        for genotypes, llks in zip(self.genotypes, self.llks):
            yield type(self)(genotypes[None], llks[None], self.n_allele)

    def replicate_incongruence(self, threshold=0.6):
        """0/1/2 = congruent / incongruent / putative CNV.

        Reference: calling/classes.py:228-260.
        """
        out = 0
        chain_modes = [
            chain.posterior().mode(genotype_support=True) for chain in self.split()
        ]
        alleles = [mode[0] for mode in chain_modes if mode[-1] >= threshold]
        mode_count = len({array.tobytes() for array in alleles})
        if mode_count > 1:
            out = 1
            ploidy = len(alleles[0])
            allele_count = len(set(np.array(alleles).ravel()))
            if allele_count > ploidy:
                out = 2
        return out

    def posterior_frequencies(self):
        """(freqs, counts, occurrence) of alleles over the merged trace.

        Reference ``_posterior_frequencies`` (classes.py:277-297).
        """
        g = self.genotypes.reshape(-1, self.genotypes.shape[-1])
        n_obs, ploidy = g.shape
        counts = np.bincount(g.ravel(), minlength=self.n_allele).astype(float)
        # occurrence: count each allele once per genotype observation
        eq = g[:, :, None] == g[:, None, :]
        first = ~np.any(np.tril(eq, k=-1), axis=-1)  # slot is first occurrence
        occurrence = np.bincount(g[first], minlength=self.n_allele).astype(float)
        counts /= n_obs
        occurrence /= n_obs
        return counts / ploidy, counts, occurrence


@dataclass
class PosteriorGenotypeAllelesDistribution:
    """Posterior over observed genotypes; reference classes.py:300-368."""

    genotypes: np.ndarray
    probabilities: np.ndarray

    def mode(self, genotype_support=False):
        """Mode genotype, optionally with genotype-support statistics."""
        if genotype_support is False:
            idx = np.argmax(self.probabilities)
            return self.genotypes[idx], self.probabilities[idx]
        # group genotypes by their allele-support set
        labels = {}
        probs = {}
        assignment = np.zeros(len(self.genotypes), dtype=int)
        for i, gen in enumerate(self.genotypes):
            key = np.unique(gen).tobytes()
            if key not in labels:
                labels[key] = i
                probs[i] = self.probabilities[i]
            else:
                probs[labels[key]] += self.probabilities[i]
            assignment[i] = labels[key]
        keys, vals = zip(*probs.items())
        mode_label = keys[int(np.argmax(vals))]
        idx = assignment == mode_label
        genotypes = self.genotypes[idx]
        prob = self.probabilities[idx]
        best = np.argmax(prob)
        return genotypes[best], prob[best], prob.sum()

    def as_array(self, n_alleles):
        """Dense probability vector over all possible genotypes."""
        _, ploidy = self.genotypes.shape
        out = np.zeros(count_unique_genotypes(n_alleles, ploidy))
        idx = genotype_alleles_as_index(np.sort(self.genotypes, axis=-1))
        out[idx] = self.probabilities
        return out
