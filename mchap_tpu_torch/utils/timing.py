"""Spans and counters of the port's pipeline, and the run's summary.

MCHap itself has no tracing (SURVEY §5: the VCF is its only output).
Here the first question about a run is which host or device stage sets
its pace, so the applications open a span around each stage and around
the work inside it, and count what each stage handled.

Activation (stderr and the named file only; the VCF is never touched):

- ``MCHAP_TIMING=1``      — records spans and counters; at the end of the
                            run, prints the span tree (per name under its
                            parents: count, total and self time, the total
                            as a share of the run) and the counters.  Each
                            span is added to its path's totals as it
                            closes, so memory stays flat over a run.
- ``MCHAP_TRACE=<path>``  — records them too, keeps every span and counter
                            event (``spans``, ``counter_events``: about two
                            spans per (locus, sample)), and at the end of
                            the run writes them to ``path`` as Chrome
                            trace-event JSON (``chrome_trace``).
- ``MCHAP_PROGRESS=<N>``  — a progress line every N loci.

A span records an id, its parent's id (the innermost span open when it
opened), its name, its start and end from ``time.time_ns()`` (the clock
of ``torch.profiler``'s host and device timestamps, so a span and the
kernels launched inside it line up) and a few attributes (``block``,
``loci``, ``locus``, ``sample``, ``file``, ``shards``).  The spans, each
nested under the one named:

- ``read_loci``          (root) BED/VCF/FASTA locus construction.
- ``block``              (root) one block of loci (``application/
                         baseclass.run_stdout``): ``block`` its index,
                         ``loci`` its size.
- ``encode_reads``       (block) reads to encoded, de-duplicated reads.
- ``io.read_extract``    (encode_reads) the alleles of one (locus,
                         sample)'s reads at the SNVs.
- ``io.alignment_load``  (io.read_extract) an alignment file decoded
                         whole (SAM, BAM without index, CRAM), once.
- ``encoding.reads``     (encode_reads) one (locus, sample)'s
                         probabilistic encoding and de-duplication.
- ``device_sampler``     (block) the sampler: chain set-up, launches,
                         traces back to the host.
- ``device.launch``, ``device.sync`` (device_sampler) the launches of a
                         block's shards, and the wait for the cards
                         (``parallel/sharding.run_sharded``).  A kernel's
                         own time comes from the profiler.
- ``device.homfilter``, ``host.chain_init``, ``device.tabulate``,
  ``device.trace_fetch``, ``device.trace_unpack`` (device_sampler) the
                         fits' steps (``models/*``).
- ``pedigree.prep``      (device_sampler) ``call-pedigree``'s host work
                         before the launch (``models/pedigree._fit``: the
                         read-haplotype matrices, the greedy start, K3's
                         plan): ``loci``, ``samples``.
- ``summarize_format``   (block) posteriors and VCF records.
- ``posterior.samples``  (summarize_format) one locus's posteriors and
                         per-sample fields; ``host.posterior_tab`` inside.
- ``pedigree.incongruence``, ``pedigree.posterior`` (posterior.samples)
                         ``call-pedigree``'s PEDERR pass over one locus's
                         joint trace, then its per-sample summaries.
- ``vcf.record``         (summarize_format) one locus's INFO and record.

Every tool runs its loci through one block loop
(``application/baseclass._call_locus_block``), so this is the tree of
every tool at every ``--locus-batch``, 1 included.

The top-level stages ``read_loci``, ``encode_reads``, ``device_sampler``
and ``summarize_format`` never nest in one another.  The counters:
``io.records_decoded``, ``io.reads_extracted``, ``io.snv_calls`` (the
(read, SNV) calls read off reads, before mates merge; counted in
``io/bam.extract_read_variants``), ``encoding.unique_reads``,
``sampler.problems`` (problems this process ran), ``sampler.steps``
(compound MCMC steps: problems x chains x steps),
``denovo.overflow_problems`` (problems whose tabulation overflowed) and,
for ``call-pedigree``, ``pedigree.sample_updates`` (slot updates: loci x
chains x steps x the samples' slots), ``pedigree.pair_swaps`` (loci x
chains x steps x parental pairs), ``pedigree.waves`` (K3's waves, once
a block) and ``pedigree.incongruence_checks`` (the (kept state, sample)
pairs the PEDERR pass judged, trios and duos, counted in
``ops/pedigree_mcmc.trace_incongruence``).

With recording off, a span or a counter costs one flag check.  All
state lives in the ``TIMERS`` singleton (one run streams one VCF);
``reset()`` re-reads the environment.  ``stage()`` looks ``TIMERS.stage``
up at each call, so a wrapper put in its place sees every span.
"""

import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext

_OFF = nullcontext()


def _flag(name):
    return (os.environ.get(name, "") or "0") not in ("0", "false", "False")


class Span:
    """One recorded span; ``end`` is None while it is open.  ``path`` is
    its node in the span tree, ``child_ns`` its closed children's time."""

    __slots__ = ("id", "parent", "name", "start", "end", "attrs", "path", "child_ns")

    def __init__(self, id, parent, name, start, path):
        self.id, self.parent, self.name = id, parent, name
        self.start, self.end, self.attrs = start, None, {}
        self.path, self.child_ns = path, 0


class PipelineTimers:
    """Records spans and counters (with ``MCHAP_TIMING`` or
    ``MCHAP_TRACE``) and the emitted loci."""

    def __init__(self):
        progress = os.environ.get("MCHAP_PROGRESS", "") or "0"
        try:
            self.progress_every = int(progress)
        except ValueError:
            self.progress_every = 0
        self.timing = _flag("MCHAP_TIMING")
        self.trace_path = os.environ.get("MCHAP_TRACE", "")
        self.enabled = self.timing or bool(self.trace_path)
        self.stages = {}  # name -> total seconds, nested spans included
        self.tree = {}  # path of names -> [count, total ns, self ns], in first-open order
        self.spans = []  # MCHAP_TRACE only: every span, in the order they opened
        self.counters = {}
        self.counter_events = []  # MCHAP_TRACE only: (time ns, name, running total)
        self._n_spans = 0
        self.loci = 0
        self.sample_calls = 0
        self._open = []
        self._t0 = None

    # -- recording ----------------------------------------------------

    def _start_clock(self):
        if self._t0 is None:
            self._t0 = time.time_ns()

    def stage(self, name):
        """A context manager recording a span ``name`` under the innermost
        open span (attributes: ``annotate``)."""
        if not self.enabled:
            return _OFF
        return self._record(name)

    @contextmanager
    def _record(self, name):
        self._start_clock()
        parent = self._open[-1] if self._open else None
        path = (parent.path if parent else ()) + (name,)
        self._n_spans += 1
        span = Span(self._n_spans, parent and parent.id, name, time.time_ns(), path)
        self.tree.setdefault(path, [0, 0, 0])
        if self.trace_path:
            self.spans.append(span)
        self._open.append(span)
        try:
            yield span
        finally:
            span.end = time.time_ns()
            self._open.pop()
            dur = span.end - span.start
            node = self.tree[path]
            node[0] += 1
            node[1] += dur
            node[2] += dur - span.child_ns
            if parent is not None:
                parent.child_ns += dur
            self.stages[name] = self.stages.get(name, 0.0) + dur / 1e9

    def annotate(self, attrs):
        """Add ``attrs`` to the innermost open span."""
        if self._open:
            self._open[-1].attrs.update(attrs)

    def count(self, name, n=1):
        """Add ``n`` to counter ``name``."""
        if not self.enabled:
            return
        total = self.counters[name] = self.counters.get(name, 0) + n
        if self.trace_path:
            self.counter_events.append((time.time_ns(), name, total))

    def tick_loci(self, n=1, sample_calls=0):
        """Count emitted loci; emits a progress line when due."""
        if not (self.enabled or self.progress_every):
            return
        self._start_clock()
        before = self.loci
        self.loci += n
        self.sample_calls += sample_calls
        every = self.progress_every
        if every and (before // every) != (self.loci // every):
            elapsed = (time.time_ns() - self._t0) / 1e9
            rate = self.loci / elapsed if elapsed > 0 else float("nan")
            sys.stderr.write(
                f"[mchap-tpu] {self.loci} loci in {elapsed:.1f}s"
                f" ({rate:.2f} loci/s)\n"
            )

    # -- reporting ----------------------------------------------------

    def span_tree(self):
        """The closed spans summed by their path of names from the root:
        a list of (path, count, total s, self s), each parent before its
        children, siblings in the order they first opened."""
        first = {path: i for i, path in enumerate(self.tree)}
        rows = [(path, c, total / 1e9, own / 1e9)
                for path, (c, total, own) in self.tree.items() if c]
        # depth-first: a path sorts by its ancestors' places in first-open order
        return sorted(rows, key=lambda r: [first[r[0][:k]] for k in range(1, len(r[0]) + 1)])

    def summary_lines(self):
        elapsed = (time.time_ns() - self._t0) / 1e9 if self._t0 is not None else 0.0
        rate = self.loci / elapsed if elapsed > 0 else float("nan")
        lines = [
            f"timing: {self.loci} loci, {self.sample_calls} sample-calls"
            f" in {elapsed:.2f}s ({rate:.2f} loci/s)",
            f"  {'span':<30} {'count':>7} {'total s':>9} {'% run':>6} {'self s':>9}",
        ]
        for path, n, total, own in self.span_tree():
            frac = 100.0 * total / elapsed if elapsed > 0 else 0.0
            name = "  " * (len(path) - 1) + path[-1]
            lines.append(f"  {name:<30} {n:>7} {total:>9.3f} {frac:>6.1f} {own:>9.3f}")
        counters = self.counters
        if counters:
            lines.append(
                "  counters: " + ", ".join(f"{k} {v:.6g}" for k, v in counters.items())
            )
        if counters.get("io.reads_extracted"):
            share = counters.get("encoding.unique_reads", 0) / counters["io.reads_extracted"]
            lines.append(f"  encoding: {share:.4f} unique reads per read extracted")
            calls = counters.get("io.snv_calls", 0) / counters["io.reads_extracted"]
            lines.append(f"  io: {calls:.4f} SNV calls per read extracted")
        steps = counters.get("sampler.steps", 0)
        if steps:
            sps = steps / elapsed if elapsed > 0 else 0.0
            lines.append(
                f"  sampler: {steps:.3g} compound steps ({sps:.3g} steps/s aggregate)"
            )
        from mchap_tpu_torch.utils import fallback

        lines.extend("  " + line for line in fallback.summary_lines())
        return lines

    def chrome_trace(self, base_ns=0):
        """The spans and counters as Chrome trace-event JSON (a dict): a
        complete event per closed span, its id, parent and attributes
        under ``args``, and a counter event per count.  Times are µs of
        ``time.time_ns()`` less ``base_ns``; pass a ``torch.profiler``
        export's ``baseTimeNanoseconds`` to put both on one time axis, so
        the two ``traceEvents`` lists can be joined and opened together."""
        pid = os.getpid()
        events = [dict(ph="M", name="thread_name", pid=pid, tid=0, args=dict(name="mchap spans"))]
        for s in self.spans:
            if s.end is None:
                continue
            events.append(dict(
                ph="X", cat="mchap", name=s.name, pid=pid, tid=0,
                ts=(s.start - base_ns) / 1e3, dur=(s.end - s.start) / 1e3,
                args=dict(s.attrs, id=s.id, parent=s.parent),
            ))
        for t, name, total in self.counter_events:
            events.append(dict(ph="C", cat="mchap", name=name, pid=pid, tid=0,
                               ts=(t - base_ns) / 1e3, args={name: total}))
        return dict(traceEvents=events, displayTimeUnit="ns", baseTimeNanoseconds=base_ns,
                    otherData=dict(clock="time.time_ns", counters=self.counters))

    def report(self):
        """At the end of a run: the summary to stderr (``MCHAP_TIMING``)
        and the trace to its file (``MCHAP_TRACE``)."""
        if self.timing:
            for line in self.summary_lines():
                sys.stderr.write(f"[mchap-tpu] {line}\n")
        if self.trace_path:
            with open(self.trace_path, "w") as f:
                json.dump(self.chrome_trace(), f)


TIMERS = PipelineTimers()


def reset():
    """Re-read the environment; returns the fresh singleton."""
    global TIMERS
    TIMERS = PipelineTimers()
    return TIMERS


@contextmanager
def _attributed(timers, name, attrs):
    with timers.stage(name):
        timers.annotate(attrs)
        yield


def stage(name, **attrs):
    """A span ``name`` with ``attrs``, through ``TIMERS.stage`` as it is
    now (a wrapper put there sees it); the attributes are added once the
    span is open, so a wrapper need take only the name."""
    timers = TIMERS
    if not timers.enabled:
        return _OFF
    if not attrs:
        return timers.stage(name)
    return _attributed(timers, name, attrs)


def count(name, n=1):
    timers = TIMERS
    if timers.enabled:
        timers.count(name, n)


def tick_loci(n=1, sample_calls=0):
    TIMERS.tick_loci(n, sample_calls=sample_calls)


def report():
    TIMERS.report()
