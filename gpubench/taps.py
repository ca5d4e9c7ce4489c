"""What a run reads from the program besides the VCF it writes: the
sampler stage's inputs and result, for the reference to judge.

For the length of a job, a tool's block fit (its tool file's ``tap``
names the site: ``fit_denovo_multi`` in ``application/assemble.py``,
``fit_calling_multi`` in ``application/call.py``, the one call per block
through which every (locus, sample) problem goes to the sampler) is
wrapped: each problem's encoded reads and read counts are kept, and from
the trace the sampler returns for it, a few (genotype state,
log-likelihood) pairs drawn from the seed.  The reference matches each
problem to its (locus, sample) by the reads alone, so the order of the
problems is the program's own business.  Nothing else of the program is
touched.  A site that is not in the program fails the run, naming it.
"""

import contextlib
import importlib

import numpy as np

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


def problem_entry(problem, trace, rng):
    """What the tap keeps of one problem: its ``reads`` and ``counts``,
    and ``states`` sampled from its trace."""
    return dict(reads=np.array(problem["reads"], float),
                counts=np.array(problem["counts"], float), states=sample_states(trace, rng))


@contextlib.contextmanager
def tap(site, seed, entry=problem_entry):
    """Record the sampler stage of the jobs run inside the block at
    ``site``, (module, function): a block fit that takes a list of
    problems and returns one trace each.  Yields a list that fills with
    ``entry(problem, trace, rng)`` for each problem, ``rng`` drawn from
    ``seed``.  Raises LookupError, naming the site, where the program
    has no such function."""
    module_name, name = site
    module = importlib.import_module(module_name)
    real = getattr(module, name, None)
    if real is None:
        raise LookupError(f"gpubench: the tap's site {module_name}.{name} is not in the program")
    record = []
    rng = np.random.default_rng([seed, 0x7A9])

    def fit(problems, *args, **kwargs):
        traces = real(problems, *args, **kwargs)
        for p, t in zip(problems, traces):
            record.append(entry(p, t, rng))
        return traces

    setattr(module, name, fit)
    try:
        yield record
    finally:
        setattr(module, name, real)
