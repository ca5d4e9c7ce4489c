"""What a run reads from the program besides the VCF it writes: the
sampler stage's inputs and result, for the reference to judge.

For the length of a job, the tool's block fit (``fit_denovo_multi`` in
``application/assemble.py``, ``fit_calling_multi`` in
``application/call.py``, the one call per block through which every
(locus, sample) problem goes to the sampler) is wrapped: each problem's
encoded reads and read counts are kept, and from the trace the sampler
returns for it, a few (genotype state, log-likelihood) pairs drawn from
the seed.  The reference matches each problem to its (locus, sample) by
the reads alone, so the order of the problems is the program's own
business.  Nothing else of the program is touched.  A tool whose block
fit is not found records nothing, and the run then reads no sampler
result: the check counts that as a failure, not as a pass.
"""

import contextlib
import importlib

import numpy as np

SITES = {
    "assemble": ("mchap_tpu_torch.application.assemble", "fit_denovo_multi"),
    "call": ("mchap_tpu_torch.application.call", "fit_calling_multi"),
}
STATES_PER_PROBLEM = 2


def sample_states(trace, rng, k=STATES_PER_PROBLEM):
    """Up to ``k`` (state, llk) pairs of a trace's kept steps: a de novo
    state is int[ploidy, n_snv] alleles, a calling state int[ploidy]
    indices into the problem's haplotypes."""
    if hasattr(trace, "states"):  # tabulated: each distinct state with its llk
        mask = np.asarray(trace.counts) > 0
        states, llks = np.asarray(trace.states)[mask], np.asarray(trace.llks)[mask]
    else:
        g = np.asarray(trace.genotypes)
        states = g.reshape((-1,) + g.shape[2:])
        llks = np.asarray(trace.llks).reshape(-1)
    keep = np.isfinite(llks)
    states, llks = states[keep], llks[keep]
    if len(llks) == 0:
        return []
    pick = rng.choice(len(llks), size=min(k, len(llks)), replace=False)
    return [(states[i].astype(np.int64), float(llks[i])) for i in pick]


def kept_states(trace, burn):
    """(states [N, ploidy, n_snv], counts [N]) of a de novo trace's kept
    steps over all its chains, as the program hands them on: a
    tabulated trace's distinct states with their counts, or a full
    trace's steps past ``burn`` (less what it dropped on the device),
    each counted once."""
    if hasattr(trace, "states"):
        s = np.asarray(trace.states)
        return s.reshape((-1,) + s.shape[2:]), np.asarray(trace.counts).reshape(-1)
    g = np.asarray(trace.genotypes)[:, max(burn - getattr(trace, "pre_burned", 0), 0):]
    return g.reshape((-1,) + g.shape[2:]), np.ones(g.shape[0] * g.shape[1], np.int64)


@contextlib.contextmanager
def tap(tool, seed, burn=0):
    """Record the sampler stage of the jobs run inside the block, whose
    traces keep what follows the cell's ``burn`` steps: yields a
    list that fills with one dict per problem (``reads``, ``counts``,
    ``states``, and for ``assemble`` ``kept``)."""
    record = []
    module_name, name = SITES[tool]
    module = importlib.import_module(module_name)
    real = getattr(module, name, None)
    if real is None:
        yield record
        return
    rng = np.random.default_rng([seed, 0x7A9])

    def fit(problems, *args, **kwargs):
        traces = real(problems, *args, **kwargs)
        for p, t in zip(problems, traces):
            entry = dict(reads=np.array(p["reads"], float), counts=np.array(p["counts"], float),
                         states=sample_states(t, rng))
            if tool == "assemble":  # tabulated by the judge, after the window
                entry["kept"] = kept_states(t, burn)
            record.append(entry)
        return traces

    setattr(module, name, fit)
    try:
        yield record
    finally:
        setattr(module, name, real)
