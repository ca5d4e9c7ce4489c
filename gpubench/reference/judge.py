"""The comparison that decides a run's ``correct``: what every tool's
judge shares.  Each tool (``tools/<tool>.py``) builds its judge from
these parts and its own ``Reference``; what follows is what the two
tools here, ``assemble`` and ``call``, make of them.

Every locus of every job in the window is judged through three layers,
each against the plain reference (``reads.py``, ``model.py``) worked out
again from the files the benchmark wrote:

- host read encoding: each sample's ``DP``, ``RCOUNT`` and ``RCALLS``
  in the VCF record, and the ``MEC`` of the called genotype over the
  reads' allele calls (``stats_diff``, ``mec_diff``: counts, exact);
- the sampler stage's result, as the called genotype: how far its log
  posterior lies below the best genotype over the candidate haplotypes
  (``gap_max``, nats, f64);
- the posterior summary: for ``call``, the called genotype's ``GPM``
  against its exact posterior probability over the candidates
  (``gpm_err_max``); for ``assemble``, each call's ``GT`` (with its
  ``.`` alleles), ``GPM`` and ``SPM`` against the summary that MCHap's
  rules give of the states the sampler kept, tabulated here from the
  tapped trace (``tab_diff``, exact).  That follows the program from its
  own trace, whose states the log-likelihood check above judges, so it
  holds however well the chains mix.

The candidates are, for ``call``, the panel's haplotypes (those the
prior leaves in), so the reference posterior is exact; for ``assemble``
the locus's founder haplotypes (the data writer's truth) and the
sample's own called haplotypes.  Reads span the whole amplicon, so a
genotype of other haplotypes (a recombinant, a base error taken for an
allele) is far less likely than these.  ``records_bad`` counts sample-loci with no record,
no call or a record whose alleles are not the panel's (for ``call``, a
``.`` allele among them); ``unresolved``
counts ``assemble`` calls with an allele below the reporting threshold
(``.``), which ``tab_diff`` judges and ``gap_max`` leaves out.
"""

from collections import Counter

import numpy as np
import torch

from gpubench.reference import model, reads

NUMBERS = ("records_bad", "stats_diff", "mec_diff", "encode_diff", "summary_diff", "tab_diff",
           "unresolved", "llk_err_max", "gap_max", "gpm_err_max")
# a probability written at the VCF's 3 decimals
WRITTEN = 5e-4 + 1e-9
# merged over a window's jobs by their largest value; the others add up
PER_JOB_MAX = ("unresolved", "llk_err_max", "gap_max", "gpm_err_max")
# counts that every cell holds at 0
EXACT = ("records_bad", "stats_diff", "mec_diff", "encode_diff", "summary_diff")
# what every cell of a tool judged by these numbers limits: (numbers, limit) pairs,
# each met by a limit on one of the numbers, at the limit where it is not None
REQUIRED = tuple(((k,), 0) for k in EXACT) + ((("llk_err_max",), None),
                                              (("gap_max", "gpm_err_max"), None))


def parse_vcf(text):
    """{locus ID: (REF + ALT sequences, {sample: FORMAT dict}, INFO dict)}."""
    out, samples = {}, None
    for line in text.splitlines():
        if line.startswith("##"):
            continue
        fields = line.split("\t")
        if line.startswith("#"):
            samples = fields[9:]
            continue
        keys = fields[8].split(":")
        seqs = [fields[3]] + ([] if fields[4] == "." else fields[4].split(","))
        calls = {s: dict(zip(keys, v.split(":"))) for s, v in zip(samples, fields[9:])}
        info = dict(kv.split("=", 1) if "=" in kv else (kv, "") for kv in fields[7].split(";"))
        out[fields[2]] = (seqs, calls, info)
    return out


class Reference:
    """The reference's view of one dataset under one cell: its loci and
    each sample's encoded reads, worked out once and kept.  A tool's own
    ``Reference`` (``tools/<tool>.py``) gives what differs: ``read_loci``,
    ``candidates``, ``genotype``, ``POSTERIOR``, and where it has them
    ``fits`` and ``sampler_state``."""

    # model.posterior's flat prior: over "orderings" or over "genotypes"
    POSTERIOR = "orderings"

    def __init__(self, dataset, cell):
        self.data = dataset
        self.ploidy = cell["ploidy"]
        self.samples = cell["samples"]
        self.inbreeding = cell.get("inbreeding", 0.0)
        self.error_rate = cell["base_error_rate"]
        self.kept = cell["chains"] * (cell["steps"] - cell["burn"])  # per problem, cold chains
        self.threshold = cell.get("haplotype_posterior_threshold")
        self.loci = self.read_loci(dataset)
        self._alignments = {}
        self._reads = {}
        self._index = None

    def read_loci(self, dataset):
        """The loci that the tool's VCF reports, from the dataset's files."""
        raise NotImplementedError

    def candidates(self, locus, extra=()):
        """(haplotype allele vectors [H, n_snv], prior frequencies or None)."""
        raise NotImplementedError

    def genotype(self, locus, state):
        """(haplotypes [H, n_snv], genotypes [1, ploidy] of indices into
        them) of a sampler state (a long tensor), or None for a state that
        is no genotype of this locus."""
        raise NotImplementedError

    def fits(self, locus, seqs, gt):
        """Whether a VCF record's alleles ``seqs`` and a call's ``gt``
        (allele indices, None for '.') are of a form the tool writes."""
        return True

    def sampler_state(self, called, genotype):
        """The sampler's state of a genotype that the control calls:
        ``called`` its haplotypes [ploidy, n_snv], ``genotype`` its
        indices into the candidates [ploidy]."""
        return called

    def sample_reads(self, locus, sample):
        key = (locus.name, sample)
        if key not in self._reads:
            if sample not in self._alignments:
                i = self.data["samples"].index(sample)
                self._alignments[sample] = reads.index_alignments(
                    reads.read_sam(self.data["bams"][i]))
            self._reads[key] = reads.sample_reads(self._alignments[sample], locus, self.error_rate)
        return self._reads[key]

    def read_index(self):
        """{the reads' key: (locus, sample)} over every problem the
        sampler sees (loci with at least one SNV)."""
        if self._index is None:
            self._index = {}
            for locus in self.loci:
                if len(locus.positions):
                    for s in self.samples:
                        r = self.sample_reads(locus, s)
                        self._index.setdefault(read_key(r.dists, r.counts), (locus, s))
        return self._index

    def state_llk(self, locus, sample, state, dtype=model.F64):
        """ln P(reads | genotype) of a sampler state (``genotype``).  None
        for a state that is no genotype of this locus."""
        r = self.sample_reads(locus, sample)
        found = self.genotype(locus, torch.as_tensor(np.asarray(state), dtype=torch.long))
        if found is None:
            return None
        haps, gens = found
        return float(model.log_likelihoods(torch.as_tensor(r.dists, dtype=model.F64),
                                           torch.as_tensor(r.counts, dtype=model.F64),
                                           haps, gens, dtype)[0])

    def posterior(self, locus, sample, haps, freqs, dtype=model.F64, device="cpu"):
        r = self.sample_reads(locus, sample)
        return model.posterior(r.dists, r.counts, haps, self.ploidy, freqs, self.inbreeding,
                               dtype, device, self.POSTERIOR)


def read_key(dists, counts):
    """A problem's reads as a key that ignores their order: the rows
    (nan as -1, to 9 decimals) with their counts, sorted."""
    d = np.where(np.isnan(dists), -1.0, np.round(np.asarray(dists, float), 9))
    rows = [tuple(row) + (float(c),) for row, c in zip(d.reshape(len(d), -1).tolist(),
                                                      np.asarray(counts).tolist())]
    return (np.shape(dists)[1:], tuple(sorted(rows)))


def tabulate(states, counts):
    """The posterior over genotypes that a trace's kept states give, as
    counts: each state's haplotypes put in order (a genotype is a
    multiset of haplotypes), equal genotypes merged.  ``states``
    [N, ploidy, n_snv], ``counts`` [N].  Returns (genotypes int8
    [U, ploidy, n_snv], counts int64 [U])."""
    states = np.asarray(states, np.int8)
    counts = np.asarray(counts, np.int64)
    keep = counts > 0
    states, counts = states[keep], counts[keep]
    n, ploidy, n_snv = states.shape
    if n == 0 or n_snv == 0:
        return states[:1], counts[:1].sum(keepdims=True)
    haps, hap_id = np.unique(states.reshape(n * ploidy, n_snv), axis=0, return_inverse=True)
    gens = np.sort(hap_id.reshape(n, ploidy), axis=1)
    keys, inverse = np.unique(gens, axis=0, return_inverse=True)
    totals = np.zeros(len(keys), np.int64)
    np.add.at(totals, inverse.reshape(-1), counts)
    return haps[keys], totals


def summary_of(tab):
    """What MCHap reports of one sample-locus from its tabulated trace
    (``tabulate``): the genotypes that may be called, each with its count
    and its group's count (the heaviest group of genotypes that share
    their set of haplotypes, then its heaviest genotype; every one where
    counts tie), each haplotype's occurrence (the count of the genotypes
    that hold it), and the total."""
    gens, counts = tab
    groups, occurrence = {}, Counter()
    for g, c in zip(gens, counts.tolist()):
        distinct = tuple(dict.fromkeys(h.tobytes() for h in g))
        groups.setdefault(distinct, []).append((g, c))
        for h in distinct:
            occurrence[h] += c
    weight = {k: sum(c for _, c in v) for k, v in groups.items()}
    top = max(weight.values(), default=None)
    modes = []
    for k, members in groups.items():
        if weight[k] == top:
            best = max(c for _, c in members)
            modes += [(g, c, top) for g, c in members if c == best]
    return dict(modes=modes, occurrence=occurrence, total=int(counts.sum()))


def reported(summaries, threshold):
    """{haplotype: "yes", "no" or "either"}: whether a locus's VCF record
    gives the haplotype an allele of its own, which it does where its
    occurrence reaches ``threshold`` in some sample; "either" where that
    sits within rounding of the threshold."""
    rank = {"no": 0, "either": 1, "yes": 2}
    out = {}
    for sm in summaries:
        for h, c in sm["occurrence"].items():
            share = c / sm["total"]
            status = "either" if abs(share - threshold) < 1e-9 else (
                "yes" if share > threshold else "no")
            out[h] = max(out.get(h, "no"), status, key=rank.get)
    return out


def match_summary(call, sm, status):
    """The mode of ``sm`` (``summary_of``) that a VCF call reports, with
    its ``.`` alleles, ``GPM`` and ``SPM``; None if none does."""
    resolved = Counter(np.asarray(h, np.int8).tobytes() for h in call["resolved"])
    for g, c, group in sm["modes"]:
        rows = Counter(h.tobytes() for h in g)
        dots = rows - resolved
        if (resolved - rows or sum(dots.values()) != call["n_dot"]
                or any(status.get(h) == "no" for h in resolved)
                or any(status.get(h) == "yes" for h in dots)
                or abs(call["gpm"] - c / sm["total"]) > WRITTEN
                or (call["spm"] is not None and abs(call["spm"] - group / sm["total"]) > WRITTEN)):
            continue
        return g
    return None


def judge_sampler(ref, record, n):
    """Into ``n``: the problems of a job's tap record (``taps.tap``) whose
    encoded reads match no (locus, sample) of the reference, and those
    of the reference that no problem matched (``encode_diff``); the
    largest relative error of a sampled state's log-likelihood against
    the reference's (``llk_err_max``).  Returns the worst case, and
    each matched problem's tabulated trace by (locus, sample)."""
    index = ref.read_index()
    seen, worst, tabs = set(), None, {}
    for p in record:
        hit = index.get(read_key(p["reads"], p["counts"]))
        if hit is None:
            n["encode_diff"] += 1
            continue
        locus, s = hit
        seen.add((locus.name, s))
        if "kept" in p:
            tabs[(locus.name, s)] = tabulate(*p["kept"])
        for state, llk in p["states"]:
            want = ref.state_llk(locus, s, state)
            err = float("inf") if want is None else abs(llk - want) / max(1.0, abs(want))
            if err > n["llk_err_max"]:
                n["llk_err_max"], worst = err, (locus.name, s, llk, want)
    n["encode_diff"] += len({(loc.name, s) for loc, s in index.values()} - seen)
    return worst, tabs


def _genotype_index(gens, alleles):
    want = torch.as_tensor(sorted(alleles))
    hit = (gens == want).all(dim=1).nonzero()
    return int(hit[0, 0]) if len(hit) else None


def summary_diff(rec):
    """Whether a record's INFO AN, AC, NS, DP and RCOUNT disagree with its
    samples' GT, DP and RCOUNT (the VCF summary's own arithmetic)."""
    seqs, calls, info = rec
    try:
        gts = [[int(a) for a in c["GT"].replace("|", "/").split("/") if a != "."]
               for c in calls.values()]
        counts = np.bincount([a for g in gts for a in g], minlength=len(seqs))
        want = dict(AN=str(int(counts.sum())), NS=str(sum(1 for g in gts if g)),
                    AC=",".join(str(int(c)) for c in counts[1:]) or ".",
                    DP=sum(float(c["DP"]) for c in calls.values() if c["DP"] != "."),
                    RCOUNT=sum(int(c["RCOUNT"]) for c in calls.values()))
        return (info["AN"] != want["AN"] or info["NS"] != want["NS"] or info["AC"] != want["AC"]
                or float(info["DP"]) != want["DP"] or int(info["RCOUNT"]) != want["RCOUNT"])
    except (KeyError, ValueError, IndexError):
        return True


def answers_from_vcf(ref, text):
    """The program's answers in one job's VCF: {(locus, sample): answer},
    an answer None where the record or the call is missing or malformed
    or not of a form the tool writes (``ref.fits``); and the loci whose
    record's summary disagrees with its calls."""
    records = parse_vcf(text)
    out = {}
    bad_summary = {name for name, rec in records.items() if summary_diff(rec)}
    for locus in ref.loci:
        rec = records.get(locus.name)
        for s in ref.samples:
            call = rec[1].get(s) if rec else None
            if call is None or "GT" not in call:
                out[(locus.name, s)] = None
                continue
            seqs = rec[0]
            try:
                gt = [None if a == "." else int(a) for a in call["GT"].replace("|", "/").split("/")]
                if not ref.fits(locus, seqs, gt):
                    out[(locus.name, s)] = None
                    continue
                resolved = [reads.haplotype_alleles(locus, seqs[a]) for a in gt if a is not None]
                out[(locus.name, s)] = dict(
                    haps=None if None in gt else resolved, resolved=resolved,
                    n_dot=gt.count(None), gpm=float(call["GPM"]),
                    spm=float(call["SPM"]) if "SPM" in call else None, dp=float(call["DP"]),
                    rcount=int(call["RCOUNT"]), rcalls=int(call["RCALLS"]),
                    mec=int(call["MEC"]),
                )
            except (KeyError, ValueError, IndexError):
                out[(locus.name, s)] = None
    return out, bad_summary


def start(bad_summary=()):
    """The numbers of one job before any answer is judged, and its worst
    cases, to be filled in by the tool's ``judge``."""
    n = dict.fromkeys(NUMBERS, 0)
    n["summary_diff"] = len(bad_summary)
    for k in ("llk_err_max", "gap_max", "gpm_err_max"):
        n[k] = 0.0
    return n, {}


def read_answer(ref, locus, s, a, n):
    """Into ``n``: a sample-locus with no answer (``records_bad``), or
    whose ``DP``, ``RCOUNT`` or ``RCALLS`` differ from its reads'
    (``stats_diff``).  Returns None for no answer, else (the reads,
    whether every allele is called, the called haplotypes [ploidy,
    n_snv] or None)."""
    if a is None:
        n["records_bad"] += 1
        return None
    r = ref.sample_reads(locus, s)
    if (a["dp"], a["rcount"], a["rcalls"]) != (r.depth, r.count, r.n_calls):
        n["stats_diff"] += 1
    resolved = a["haps"] is not None and not any((h < 0).any() for h in a["haps"])
    return r, resolved, np.stack(a["haps"]) if resolved else None


def mec(r, called):
    """The reads' minimum error correction against a genotype [ploidy, n_snv]."""
    return int(((r.calls[:, None, :] != called[None]) & (r.calls[:, None, :] >= 0))
               .sum(-1).min(-1).sum()) if len(r.calls) else 0


def judge_genotype(ref, locus, s, a, r, resolved, called, n, worst):
    """Into ``n``: an answer with an allele left uncalled (``unresolved``),
    then, of the genotype ``called`` stands for (None: none), its MEC
    against the answer's (``mec_diff``) and, where every allele is
    called, how far its log posterior lies below the best genotype's
    over the candidates (``gap_max``) and the answer's ``GPM`` against its
    posterior probability (``gpm_err_max``), with the worst cases."""
    if not resolved:
        n["unresolved"] += 1
    if called is None:
        return
    n["mec_diff"] += mec(r, called) != a["mec"]
    if not resolved:
        return  # the gap is the called alleles' posterior, and some are not called
    haps, freqs = ref.candidates(locus, called)
    rows = {tuple(h): i for i, h in enumerate(haps)}
    alleles = [rows.get(tuple(h)) for h in called]
    if None in alleles:  # a haplotype the prior rules out
        n["gap_max"] = float("inf")
        worst["gap_max"] = (locus.name, s, "outside the candidates")
        return
    gens, lp, probs = ref.posterior(locus, s, haps, freqs)
    g = _genotype_index(gens, alleles)
    gap = float(lp.max() - lp[g])
    err = abs(a["gpm"] - float(probs[g]))
    if gap > n["gap_max"]:
        n["gap_max"], worst["gap_max"] = gap, (locus.name, s, round(float(probs[g]), 6))
    if err > n["gpm_err_max"]:
        n["gpm_err_max"] = err
        worst["gpm_err_max"] = (locus.name, s, a["gpm"], round(float(probs[g]), 6))


def merge(numbers):
    """The window's numbers from its jobs': counts add, widest gaps max."""
    out = dict.fromkeys(NUMBERS, 0)
    for n in numbers:
        for k, v in n.items():
            out[k] = max(out[k], v) if k in PER_JOB_MAX else out[k] + v
    return out


def control(ref, dtype=torch.bfloat16, device="cpu"):
    """The reference put in the program's place and computed in
    ``dtype``: per sample-locus the posterior mode over the candidates
    (``assemble``: the founders alone) and its probability, with the
    reference's read statistics and MEC; and, as the sampler's record,
    each problem's reads with the mode's log-likelihood in ``dtype``.
    Returns (answers, record), judged like the program's."""
    answers, record = {}, []
    for locus in ref.loci:
        haps, freqs = ref.candidates(locus)
        for s in ref.samples:
            r = ref.sample_reads(locus, s)
            gens, lp, probs = ref.posterior(locus, s, haps, freqs, dtype, device)
            g = int(torch.argmax(probs.to(model.F64)))
            called = haps[gens[g].numpy()]
            answers[(locus.name, s)] = dict(
                haps=list(called), resolved=list(called), n_dot=0, spm=None,
                gpm=round(float(probs[g]), 3), dp=float(r.depth),
                rcount=r.count, rcalls=r.n_calls, mec=mec(r, called),
            )
            if len(locus.positions):
                state = ref.sampler_state(called, gens[g].numpy())
                record.append(dict(reads=r.dists, counts=r.counts,
                                   states=[(state, ref.state_llk(locus, s, state, dtype))]))
    return answers, record
