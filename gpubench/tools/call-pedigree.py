"""The tool ``mchap call-pedigree``: its tap, its reference and its judge.

A problem is one locus: every sample's reads, sampled jointly over the
pedigree.  The candidates are the panel's haplotypes (no prior
frequencies, so none is masked), and the reference posterior
(``reference/pedigree.py``) is exact: each sample's marginal over the
joint posterior of two founders and their F1.

The tap keeps, for each problem, each sample's encoded reads, the joint
kept trace, two joint states drawn from the seed, and the read-haplotype
log-likelihoods and read counts that the program hands its pedigree
sampler (K3, ``ops/cuda_pedigree.pedigree_sampler``, or the torch route,
``ops/pedigree_mcmc.pedigree_sampler``; both wrapped for the job).  The
pedigree trace carries no log-likelihoods, so ``llk_err_max`` holds the
joint log-likelihood of each drawn state, worked out from what the
sampler was handed, to the reference's from the files: the reads'
encoding and ``read_hap_loglik`` are judged, in the precision the
sampler reads them.

Besides the shared exact counts (``reference/judge.py``), per sample:

- ``tab_diff``: a call whose ``GT``, ``GPM`` and ``SPM`` are not what
  MCHap's rules make of the sample's kept states, or whose ``PEDERR``
  is not the share of kept joint states in which the sample's genotype
  cannot come from its parents' (exact, at the VCF's 3 decimals): the
  summary of the program's own trace;
- ``gpm_err_max``: ``GPM`` against the called genotype's exact marginal
  posterior probability; ``gap_max``: how far that marginal lies below
  the largest, in nats;
- ``pederr_err_max``: ``PEDERR`` against its exact posterior value.
"""

import contextlib
import functools
import importlib
import math

import numpy as np
import torch

from gpubench import taps
from gpubench.reference import judge as lib
from gpubench.reference import model, pedigree, reads

SITE = ("mchap_tpu_torch.application.call_pedigree", "fit_pedigree_multi")
WORK = "k3_roofline"
# the MCMC steps and burn of the fault tests' small run on the CPU
SMALL_RUN = (400, 200)
# the pedigree samplers a job may run: (module of the port, name, the place of
# the read-haplotype log-likelihoods among its arguments, the read counts next)
SAMPLERS = (("ops.cuda_pedigree", "pedigree_sampler", 0),
            ("ops.pedigree_mcmc", "pedigree_sampler", 3))
NUMBERS = lib.NUMBERS + ("pederr_err_max",)
PER_JOB_MAX = lib.PER_JOB_MAX + ("pederr_err_max",)
REQUIRED = lib.REQUIRED + ((("pederr_err_max",), None),)


@contextlib.contextmanager
def tap(seed, burn=0):
    """The block fit's record (``burn``: the pedigree trace keeps only
    what follows it already), with what each sampler call was handed."""
    handed = []  # (rh, counts) of each sampler call, in call order
    current = dict(rh=None, counts=None, next=0)

    def keep(real, rh_at):
        @functools.wraps(real)  # K3's launch counter lives on the module's name
        def sampler(*args, **kwargs):
            handed.append((args[rh_at], args[rh_at + 1]))
            return real(*args, **kwargs)
        return sampler

    def entry(problem, trace, rng):
        if handed:  # the samplers of a new block fit ran: its problems start here
            rh = [r.detach().to("cpu", torch.float64) for r, _ in handed]
            counts = [c.detach().to("cpu", torch.float64) for _, c in handed]
            handed.clear()
            current.update(rh=torch.cat(rh).numpy(), counts=torch.cat(counts).numpy(), next=0)
        k = current["next"]
        current["next"] += 1
        have = current["rh"] is not None and k < len(current["rh"])
        sample_reads = np.asarray(problem["sample_reads"], float)
        sample_counts = np.asarray(problem["sample_read_counts"], float)
        g = np.asarray(trace.genotypes)  # [chains, kept, S, maxp]
        flat = g.reshape((-1,) + g.shape[2:])
        pick = rng.choice(len(flat), size=min(taps.STATES_PER_PROBLEM, len(flat)), replace=False)
        return dict(
            reads=[r[c > 0] for r, c in zip(sample_reads, sample_counts)],
            counts=[c[c > 0] for c in sample_counts],
            haplotypes=np.asarray(problem["haplotypes"], np.int64),
            rh=current["rh"][k] if have else None,
            rh_counts=current["counts"][k] if have else None,
            states=[flat[i].astype(np.int64) for i in pick], kept=flat,
        )

    modules = [importlib.import_module(f"mchap_tpu_torch.{m}") for m, _, _ in SAMPLERS]
    reals = [getattr(module, name) for module, (_, name, _) in zip(modules, SAMPLERS)]
    for module, (_, name, rh_at), real in zip(modules, SAMPLERS, reals):
        setattr(module, name, keep(real, rh_at))
    try:
        with taps.tap(SITE, seed, entry) as record:
            yield record
    finally:
        for module, (_, name, _), real in zip(modules, SAMPLERS, reals):
            setattr(module, name, real)


class Reference(lib.Reference):
    POSTERIOR = "genotypes"

    def __init__(self, dataset, cell):
        super().__init__(dataset, cell)
        if cell["gamete_lambda"] != 0 or list(cell["gamete_tau"]) != [self.ploidy // 2] * 2:
            raise ValueError("the reference takes lambda 0 and gametes of half the ploidy")
        self.error = cell["gamete_error"]
        with open(dataset["pedigree"]) as f:
            rows = {s: (p, q) for s, p, q in (line.split() for line in f if line.strip())}
        place = {s: i for i, s in enumerate(self.samples)}
        place["."] = -1
        self.parents = [[place[x] for x in rows[s]] for s in self.samples]
        self._families, self._joint, self._loci_index = {}, {}, None

    def read_loci(self, dataset):
        self.panel = {p["locus"].name: p for p in reads.panel_loci(dataset["panel"])}
        return [p["locus"] for p in self.panel.values()]

    def candidates(self, locus, extra=()):
        return self.panel[locus.name]["haplotypes"], None

    def genotype(self, locus, state):
        haps = torch.as_tensor(self.candidates(locus)[0], dtype=torch.long)
        if state.shape != (self.ploidy,) or ((state < 0) | (state >= len(haps))).any():
            return None
        return haps, torch.sort(state).values[None]

    def fits(self, locus, seqs, gt):
        return (seqs == self.panel[locus.name]["sequences"] and None not in gt
                and len(gt) == self.ploidy)

    def family(self, n_haplotypes, dtype=model.F64):
        key = (n_haplotypes, dtype)
        if key not in self._families:
            self._families[key] = pedigree.Family(n_haplotypes, self.ploidy,
                                                  (self.error, self.error), None, dtype)
        return self._families[key]

    def joint(self, locus, dtype=model.F64, device="cpu"):
        """(family, marginals [S, G], PEDERR [S]) of the locus, exact."""
        key = (locus.name, dtype)
        if key not in self._joint:
            haps = torch.as_tensor(self.candidates(locus)[0], dtype=torch.long)
            fam = self.family(len(haps), dtype)
            llks = torch.stack([
                model.log_likelihoods(torch.as_tensor(r.dists, dtype=model.F64, device=device),
                                      torch.as_tensor(r.counts, dtype=model.F64, device=device),
                                      haps.to(device), fam.gens.to(device), dtype).cpu()
                for r in (self.sample_reads(locus, s) for s in self.samples)])
            self._joint[key] = (fam, *pedigree.f1_posteriors(fam, llks, self.parents))
        return self._joint[key]

    def loci_index(self):
        """{every sample's reads' key, in sample order: locus} over the
        loci the sampler sees (those with SNVs)."""
        if self._loci_index is None:
            self._loci_index = {}
            for locus in self.loci:
                if len(locus.positions):
                    key = tuple(lib.read_key(r.dists, r.counts) for r in
                                (self.sample_reads(locus, s) for s in self.samples))
                    self._loci_index.setdefault(key, locus)
        return self._loci_index


def program_llk(p, state):
    """The joint ln P(reads | genotypes) of a state [S, P] from the
    read-haplotype log-likelihoods and counts that the sampler was
    handed, in float64; None where it was handed none for this problem."""
    if p["rh"] is None:
        return None
    rh = torch.as_tensor(p["rh"])  # [S, R, H]
    s = torch.as_tensor(np.asarray(state)).clamp(min=0, max=rh.shape[2] - 1)
    cols = torch.gather(rh, 2, s[:, None, :].expand(-1, rh.shape[1], -1))  # [S, R, P]
    per_read = torch.logsumexp(cols, dim=2) - math.log(s.shape[1])
    return float((per_read * torch.as_tensor(p["rh_counts"])).sum())


def judge_sampler(ref, record, n):
    """Into ``n``: the samples of problems whose reads match no locus of
    the reference (or whose haplotypes are not its panel's), and of loci
    that no problem matched (``encode_diff``); the largest relative error
    of a drawn joint state's log-likelihood (``llk_err_max``).  Returns
    the worst case and each matched problem's kept trace by locus."""
    index = ref.loci_index()
    seen, worst, kept = set(), None, {}
    S = len(ref.samples)
    for p in record:
        locus = index.get(tuple(lib.read_key(r, c) for r, c in zip(p["reads"], p["counts"])))
        if locus is None or not np.array_equal(p["haplotypes"], ref.candidates(locus)[0]):
            n["encode_diff"] += S
            continue
        seen.add(locus.name)
        trace = p.get("kept")
        if trace is not None and ((trace < 0) | (trace >= len(p["haplotypes"]))).any():
            trace = None  # no genotypes of this locus: every call's summary differs
        kept[locus.name] = trace
        for state in p["states"]:
            got = program_llk(p, state)
            parts = [ref.state_llk(locus, s, state[i]) for i, s in enumerate(ref.samples)]
            want = None if None in parts else sum(parts)
            err = (float("inf") if got is None or want is None
                   else abs(got - want) / max(1.0, abs(want)))
            if err > n["llk_err_max"]:
                n["llk_err_max"], worst = err, (locus.name, got, want)
    n["encode_diff"] += S * len({loc.name for loc in index.values()} - seen)
    return worst, kept


def kept_summaries(ref, locus, kept):
    """Per sample, MCHap's summary of its kept states (``lib.summary_of``,
    each haplotype as its panel index) and the share of kept joint states
    in which its genotype cannot come from its parents'."""
    fam = ref.joint(locus)[0]
    H = len(ref.candidates(locus)[0])
    states = np.sort(kept, axis=-1)  # [N, S, P]
    code = (states * H ** np.arange(ref.ploidy)).sum(-1)  # [N, S]
    lookup = np.zeros(H ** ref.ploidy, np.int64)
    lookup[(fam.gens.numpy() * H ** np.arange(ref.ploidy)).sum(-1)] = np.arange(fam.n_genotypes)
    gen = torch.as_tensor(lookup[code])
    support = fam.support()
    out = []
    for i, (p, q) in enumerate(ref.parents):
        tab = lib.tabulate(states[:, i, :, None], np.ones(len(states), np.int64))
        err = 0.0 if p < 0 else float(1.0 - support[gen[:, p], gen[:, q], gen[:, i]].double().mean())
        out.append((lib.summary_of(tab), err))
    return out


def judge(ref, answers, record, bad_summary=()):
    """Numbers of one job's answers and record summaries
    (``answers_from_vcf``) and sampler record (``tap``) against the
    reference, and the worst sample-locus behind each widest gap."""
    n, worst = lib.start(bad_summary)
    n["pederr_err_max"] = 0.0
    worst["llk_err_max"], kept = judge_sampler(ref, record, n)
    for locus in ref.loci:
        fam, marginals, pederr = ref.joint(locus)
        trace = kept.get(locus.name)
        summaries = kept_summaries(ref, locus, trace) if trace is not None else None
        rows = {tuple(g): i for i, g in enumerate(fam.gens.tolist())}
        panel = {tuple(h): i for i, h in enumerate(ref.candidates(locus)[0].tolist())}
        for i, s in enumerate(ref.samples):
            a = answers.get((locus.name, s))
            got = lib.read_answer(ref, locus, s, a, n)
            if got is None:
                continue
            r, resolved, called = got
            if called is None:
                n["unresolved"] += 1
                continue
            n["mec_diff"] += lib.mec(r, called) != a["mec"]
            alleles = sorted(panel[tuple(h)] for h in called.tolist())
            g = rows[tuple(alleles)]
            if summaries is None or len(locus.positions) == 0:
                tab_ok = summaries is None and len(locus.positions) == 0
            else:
                sm, err = summaries[i]
                call = dict(a, resolved=[np.array([x], np.int8) for x in alleles])
                tab_ok = (lib.match_summary(call, sm, {}) is not None
                          and abs(a["pederr"] - err) <= lib.WRITTEN)
            if not tab_ok:
                n["tab_diff"] += 1
                worst["tab_diff"] = (locus.name, s, a["gpm"], a["pederr"])
            prob = float(marginals[i, g])
            gap = float(torch.log(marginals[i].max()) - math.log(prob)) if prob > 0 else math.inf
            for name, value, case in (
                    ("gap_max", gap, round(prob, 6)),
                    ("gpm_err_max", abs(a["gpm"] - prob), (a["gpm"], round(prob, 6))),
                    ("pederr_err_max", abs(a["pederr"] - float(pederr[i])),
                     (a["pederr"], round(float(pederr[i]), 6)))):
                if value > n[name]:
                    n[name], worst[name] = value, (locus.name, s, case)
    return n, worst


def answers_from_vcf(ref, text):
    """The shared answers, each with its ``PEDERR``; a call without one
    is malformed (None)."""
    out, bad_summary = lib.answers_from_vcf(ref, text)
    records = lib.parse_vcf(text)
    for (name, s), a in out.items():
        if a is not None:
            try:
                a["pederr"] = float(records[name][1][s]["PEDERR"])
            except (KeyError, ValueError):
                out[(name, s)] = None
    return out, bad_summary


def merge(numbers):
    """The window's numbers from its jobs': counts add, widest gaps max."""
    out = dict.fromkeys(NUMBERS, 0)
    for n in numbers:
        for k, v in n.items():
            out[k] = max(out[k], v) if k in PER_JOB_MAX else out[k] + v
    return out


def control(ref, dtype=torch.bfloat16, device="cpu"):
    """The reference put in the program's place and computed in
    ``dtype``: per sample-locus the marginal mode of the joint posterior,
    its probability and PEDERR, with the reference's read statistics and
    MEC; and, as the sampler's record, each locus's reads with the
    read-haplotype log-likelihoods in ``dtype`` and the joint mode state.
    Returns (answers, record), judged like the program's."""
    answers, record = {}, []
    for locus in ref.loci:
        haps = ref.candidates(locus)[0]
        fam, marginals, pederr = ref.joint(locus, dtype, device)
        mode = torch.argmax(marginals.to(model.F64), dim=1)
        for i, s in enumerate(ref.samples):
            r = ref.sample_reads(locus, s)
            called = haps[fam.gens[mode[i]].numpy()]
            answers[(locus.name, s)] = dict(
                haps=list(called), resolved=list(called), n_dot=0, spm=None,
                gpm=round(float(marginals[i, mode[i]]), 3), pederr=round(float(pederr[i]), 3),
                dp=float(r.depth), rcount=r.count, rcalls=r.n_calls, mec=lib.mec(r, called))
        if len(locus.positions):
            rs = [ref.sample_reads(locus, s) for s in ref.samples]
            R = max(max(len(r.counts) for r in rs), 1)
            rh = torch.full((len(rs), R, len(haps)), -1e30, dtype=model.F64)
            counts = torch.zeros(len(rs), R, dtype=model.F64)
            for i, r in enumerate(rs):
                q = torch.log(torch.nan_to_num(torch.as_tensor(r.dists), nan=1.0)).to(dtype)
                idx = torch.as_tensor(haps).T[None].expand(len(r.counts), -1, -1)
                rh[i, :len(r.counts)] = model._sum(torch.gather(q, 2, idx), 1, dtype).double()
                counts[i, :len(r.counts)] = torch.as_tensor(r.counts)
            record.append(dict(reads=[r.dists for r in rs], counts=[r.counts for r in rs],
                               haplotypes=np.asarray(haps), rh=rh.numpy(),
                               rh_counts=counts.numpy(), states=[fam.gens[mode].numpy()]))
    return answers, record


def problems(ref, cell):
    """Each locus's problem as the pedigree sampler's mathematics sees it,
    for the work counts of ``metrics/``: each sample's distinct reads, the
    haplotypes chosen among, and each sample's parents."""
    return [dict(reads=[len(ref.sample_reads(locus, s).counts) for s in ref.samples],
                 haplotypes=len(ref.candidates(locus)[0]), parents=ref.parents)
            for locus in ref.loci if len(locus.positions)]


def unchanged_samplers():
    """The samplers this tool's jobs run, as (module of the port, name, a
    version whose every step returns the chains' initial state: each
    (locus, sample)'s greedy genotype), for the fault test of a state
    left unchanged: K3 (``ops/cuda_pedigree.pedigree_sampler``) and the
    torch pedigree route (``ops/pedigree_mcmc.pedigree_sampler``)."""
    def k3_unchanged(real):
        @functools.wraps(real)  # K3's launch counter lives on the module's name
        def frozen(rh, counts, freqs, n_valid, problem, initial, plan, *, n_steps, **kwargs):
            real(rh, counts, freqs, n_valid, problem, initial, plan, n_steps=1, **kwargs)
            return initial[:, None].repeat(1, n_steps, 1, 1).to(torch.int16)
        return frozen

    def route_unchanged(real):
        @functools.wraps(real)
        def frozen(seed, row_offset, initial, *args, n_steps, **kwargs):
            return initial[:, None].repeat(1, n_steps, 1, 1).long()
        return frozen

    return [("ops.cuda_pedigree", "pedigree_sampler", k3_unchanged),
            ("ops.pedigree_mcmc", "pedigree_sampler", route_unchanged)]
