"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (needs CUDA; exits nonzero without it)

Builds the port's CUDA kernel libraries from ``mchap_tpu_torch/csrc``
in parallel -- ``denovo_sampler.cu`` twice (K1, the de novo sampler,
flat with K0, one mutation sweep; and K1 with its tempering ladder and
prior), ``calling_sampler.cu`` (K2, the calling sampler) and
``pedigree_sampler.cu`` (K3, the pedigree Gibbs sampler) -- and runs
twenty-six phases, each printing its lines:

A. K1 vs its plain PyTorch version on the card, pinned noise;
B. K1 with its own Philox stream vs exact enumeration;
C. ``mchap assemble`` end to end through the port's CLI entry point on
   a synthetic 22-sample x 20-locus tetraploid dataset, counting K1
   launches and checking genotype calls against the truth;
D. K1 and plain throughput at 16,384 chains x 200 steps;
E. K2 vs its plain version, pinned noise;
F. K2 with its own Philox stream vs exact enumeration, on a panel of 4
   haplotypes and one of 33, and vs its plain version fed the same
   draws;
G. ``mchap call`` end to end on phase C's reads with phase C's output
   VCF as the haplotype panel, counting K2 launches;
H. K2 and plain throughput at 65,536 chains x 500 steps;
I. K0 vs its plain version, pinned noise, then one sweep timed;
J. K3 vs its plain version, pinned noise: a bi-parental pedigree, one
   with selfed samples, one with backcrosses, one with mixed ploidies,
   one over three generations and a hexaploid family;
K. K3 with its own Philox stream vs exact enumeration of small pedigrees;
L. ``mchap call-pedigree`` end to end on a synthetic 2 + 20 tetraploid
   family over 20 loci, counting K3 launches;
M. K3 and plain throughput at the pedigree bench shape, with K3's waves
   and warps per block;
N. K1 vs its plain version in its tempered and prior modes (T = 3 flat,
   T = 1 with alpha, T = 3 with alpha, and phase P's T = 2, flat and
   with dispersions at phase P's size), pinned noise;
O. K1 with its own Philox stream in those modes vs exact enumeration;
P. ``mchap assemble --mcmc-temperatures 0.5 1.0 --use-dirmul-prior 0.1``
   end to end on phase C's data, counting K1 launches;
Q. K1 throughput at phase D's shape with 4 rungs and the prior;
R. ``call``'s model at ploidy 9 takes the torch sampler, chosen before
   any launch: K2's launch count does not move;
S. K1 at the latency shape of phase C's launches (440 problems x 2
   chains, NB48): kernel vs plain on its first steps, then timed;
T. K1 at ploidy 10 and 12 vs its plain version, at ploidy 10 vs exact
   enumeration, and ``mchap assemble --ploidy 10`` end to end;
U. K1 on read buckets whose state exceeds shared memory (P4 over 16,384
   reads, P8 over 4,096, with rungs and the prior) vs its plain version;
V. K2 at the latency shape of phase G's launch (440 problems x 2 chains,
   R16, H6): kernel vs plain on its first steps, then timed;
W. the torch de novo sampler (``ops/assemble_mcmc.py``, no kernel of its
   own): ``fit_denovo_multi``'s route at ploidy 4 (K1), 14, with 9 rungs
   and with a prior where one sample has F = 0 (the torch sampler); the
   sampler vs exact enumeration on the card; ``mchap assemble
   --use-dirmul-prior FILE`` on phase C's data with one sample at F = 0,
   so every block takes it, and its ms per step eager and as a CUDA graph;
X. ``mchap call-exact`` end to end on phase C's reads with phase C's
   output VCF as the panel, the block path and (``--report GP``) the
   per-locus path;
Y. ``mchap find-snvs`` on phase C's files and ``mchap atomize`` on
   ``call-exact``'s output over C's founder haplotypes;
Z. a block's problems over a list of devices (``parallel/``): K1 at
   phase S's shape (flat, and T = 3 with alpha), K2 at phase G's launch
   shape and K3 through the pedigree model at phase M's, each split
   three ways on the one card against the unsharded launch (identical
   genotypes and llks); ``mchap call`` as phase G in two processes on the
   card, rank 0 writing phase G's records and rank 1 none; the INFO pools
   on the card against the host formulas.

Each kernel's least time on the card (``bound_ms``) is the largest of
its f32 operations over 67 TFLOP/s, its f64 operations over 33.5
TFLOP/s, its transcendentals (exp, log) over the special-function units'
rate (16 per SM per clock, CUDA C++ Programming Guide, compute
capability 9.0, at the card's maximum SM clock) and its bytes over 3.35
TB/s; operations are counted from the kernel's source at the phase's
shapes (``*_work``), leaving out work that depends on the data
(accepted moves, gated structural steps, gamete rows), so the bound
stays a lower bound.  The line before last is a JSON object describing
each kernel; the last line is ``{"ok": true, "device": {...}}``.  Any
failure raises.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / ".build" / "chip_smoke"


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _time_cuda(fn, repeats):
    """Mean milliseconds per call over ``repeats`` calls, CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def _problems(rng, n_problems, P, NB, A, R, error_rate=0.0024, n_distinct=None):
    """Per-problem log reads [S, NB, A, R] simulated from random haplotypes
    (``n_distinct`` of them, each repeated, when given)."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops.likelihood import prepare_reads
    from mchap_tpu_torch.testing import simulate_reads

    lr = np.zeros((n_problems, NB, A, R), np.float32)
    for s in range(n_problems):
        haps = rng.integers(0, A, size=(n_distinct or P, NB))[np.arange(P) % (n_distinct or P)]
        reads = simulate_reads(
            haps, n_alleles=A, n_reads=R, errors=True, error_rate=error_rate,
            seed=int(rng.integers(1 << 30)),
        )
        lr[s] = prepare_reads(reads, dtype=torch.float32).numpy().transpose(1, 2, 0)
    return lr


def _inputs(rng, S, P, NB, A, R, C, device, **reads):
    import numpy as np
    import torch

    lr = _problems(rng, S, P, NB, A, R, **reads)
    prob = (np.arange(C) % S).astype(np.int32)
    g0 = rng.integers(0, A, size=(P, NB, C)).astype(np.int32)
    nall = np.full((S, NB), A, np.int32)
    counts = np.ones((S, R), np.float32)
    pbreak = np.full(S, 0.75 / (NB - 1), np.float32)
    return [
        torch.from_numpy(x).to(device)
        for x in (lr, counts, g0, nall, pbreak, prob)
    ]


LATENCY = dict(S=440, chains=2, P=4, NB=48, A=3, R=64, steps=200)
# K2's launch in phase G, as phase G prints it: 440 problems (22 samples x
# 20 loci) x 2 chains, a problem's chains adjacent, P4, read bucket R16 (a
# sample's distinct reads at a locus, with counts), panels padded to H6,
# and (n_valid, run) pairs over the problems: all 6.
LATENCY_K2 = dict(S=440, chains=2, P=4, R=16, H=6, n_valid=((6, 440),), adjacent=True)


def _latency_inputs(rng, device, S=LATENCY["S"], chains=LATENCY["chains"],
                    NB=LATENCY["NB"], R=LATENCY["R"]):
    """K1's inputs at the shape of phase C's launches: 440 problems (22
    samples x 20 loci) x 2 chains, chains of a problem adjacent as
    ``models/assemble.py`` lays them out, P4, phase C's ~43 SNVs per locus
    padded to NB 48, R64.  A is 3 as in phase C's batch: every fourth
    problem has one triallelic position (nall 3), the rest are biallelic
    (nall 2)."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops.likelihood import prepare_reads
    from mchap_tpu_torch.testing import simulate_reads

    P, A = LATENCY["P"], LATENCY["A"]
    lr = np.zeros((S, NB, A, R), np.float32)
    nall = np.full((S, NB), 2, np.int32)
    for s in range(S):
        haps = rng.integers(0, 2, size=(P, NB))
        if s % 4 == 0:
            haps[:, 0] = rng.integers(0, 3, size=P)
            nall[s, 0] = 3
        reads = simulate_reads(haps, n_alleles=A, n_reads=R, seed=int(rng.integers(1 << 30)))
        lr[s] = prepare_reads(reads, dtype=torch.float32).numpy().transpose(1, 2, 0)
    C = S * chains
    prob = np.repeat(np.arange(S), chains).astype(np.int32)
    g0 = rng.integers(0, 2, size=(P, NB, C)).astype(np.int32)
    counts = np.ones((S, R), np.float32)
    pbreak = np.full(S, 0.75 / (NB - 1), np.float32)
    return [
        torch.from_numpy(x).to(device)
        for x in (lr, counts, g0, nall, pbreak, prob)
    ]


def _recompute_llks(trace, lr, prob, P, A):
    """From-scratch f64 llk of every traced genotype: [n_steps, C]."""
    import torch

    from mchap_tpu_torch.ops.cuda_denovo import next_pow2

    base = next_pow2(A)
    n_steps, NB, C = trace.shape
    lrc = lr.double()[prob.long()]  # [C, NB, A, R]
    out = torch.empty((n_steps, C), dtype=torch.float64, device=lr.device)
    for s in range(n_steps):
        t = trace[s].long()  # [NB, C]
        rows = []
        for h in range(P):
            a = (t // base ** h) % base  # [NB, C]
            idx = a.T[:, :, None, None].expand(C, NB, 1, lrc.shape[-1])
            rows.append(torch.gather(lrc, 2, idx)[:, :, 0, :].sum(1))  # [C, R]
        rh = torch.stack(rows, 1)  # [C, P, R]
        out[s] = (torch.logsumexp(rh, 1) - torch.log(torch.tensor(float(P)))).sum(1)
    return out


def phase_a(device):
    """Kernel vs plain on the card, same pinned noise."""
    import numpy as np

    P, NB, R, C, STEPS = 4, 16, 64, 1024, 300
    worst = {}
    for A in (2, 3):
        rng = np.random.default_rng(100 + A)
        args = _inputs(rng, 16, P, NB, A, R, C, device)
        frac, err, t_k, l_k = _kernel_vs_plain(args, STEPS, seed=A)
        rec = _recompute_llks(t_k, args[0], args[5], P, A)
        rec_err = (rec - l_k.double()).abs().max().item()
        print(
            f"phase A (A={A}): identical chains {frac:.4f} of {C} over"
            f" {STEPS} steps; llk |kernel-plain| on them {err:.3g}"
            f" (bound 1e-3); llk vs recompute {rec_err:.3g} (bound 1e-2)",
            flush=True,
        )
        if frac < 0.99 or err > 1e-3 or rec_err > 1e-2:
            _fail(f"phase A (A={A})")
        worst[A] = err
    return max(worst.values())


def phase_b(device):
    """Kernel with in-kernel Philox vs exact enumeration (TV < 0.03)."""
    import numpy as np
    import torch

    from mchap_tpu_torch.numerics.combinadics import genotype_alleles_as_index
    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops import cuda_denovo as K
    from mchap_tpu_torch.ops.likelihood import prepare_reads
    from mchap_tpu_torch.testing import simulate_reads

    P, NB, A = 4, 2, 2
    haplotypes = np.array([[0, 0], [0, 1], [1, 1], [0, 0]], np.int8)
    reads = simulate_reads(
        haplotypes, n_alleles=A, n_reads=8, errors=False, uniform_sample=True,
        qual=(20, 20), seed=11,
    )
    R = len(reads)
    panel = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)
    llks = exact.genotype_likelihoods(reads, P, panel)
    want = exact.genotype_posteriors(llks).numpy()
    C, STEPS, BURN = 1024, 1500, 300
    lr = prepare_reads(reads, dtype=torch.float32).permute(1, 2, 0)[None]
    rng = np.random.default_rng(0)
    trace, _ = K.denovo_sampler(
        lr.contiguous().to(device),
        torch.ones((1, R), device=device),
        torch.from_numpy(rng.integers(0, A, size=(P, NB, C)).astype(np.int32)).to(device),
        torch.full((1, NB), A, dtype=torch.int32, device=device),
        torch.full((1,), 0.25, device=device),
        torch.zeros(C, dtype=torch.int32, device=device),
        n_steps=STEPS, seed=11,
    )
    g = K.unpack_genotype_trace(trace.cpu().numpy()[BURN:], P, A)  # [T, P, NB, C]
    codes = np.sort(g[:, :, 0, :] * 2 + g[:, :, 1, :], axis=1)  # [T, P, C]
    idx = genotype_alleles_as_index(codes.transpose(0, 2, 1).reshape(-1, P))
    got = np.bincount(idx, minlength=len(want)).astype(float)
    got /= got.sum()
    tv = 0.5 * np.abs(got - want).sum()
    print(f"phase B: TV(kernel, exact) = {tv:.4f} (bound 0.03)", flush=True)
    if not tv < 0.03:
        _fail("phase B")
    return tv


def _reset_launches():
    from mchap_tpu_torch.ops import cuda_calling as KC
    from mchap_tpu_torch.ops import cuda_denovo as K
    from mchap_tpu_torch.ops import cuda_pedigree as K3

    K.denovo_sampler.launches = 0
    K.mutation_sweep.launches = 0
    KC.calling_sampler.launches = 0
    K3.pedigree_sampler.launches = 0


def _launches():
    from mchap_tpu_torch.ops import cuda_calling as KC
    from mchap_tpu_torch.ops import cuda_denovo as K
    from mchap_tpu_torch.ops import cuda_pedigree as K3

    return dict(
        denovo_sampler=K.denovo_sampler.launches,
        calling_sampler=KC.calling_sampler.launches,
        mutation_sweep=K.mutation_sweep.launches,
        pedigree_sampler=K3.pedigree_sampler.launches,
    )


def _run_cli(argv):
    """Run the port's CLI in process with every launch count at 0 just
    before; returns (exit code, VCF text, wall s, launches, timers)."""
    from mchap_tpu_torch.application.cli import main as cli_main
    from mchap_tpu_torch.utils import fallback, timing

    os.environ["MCHAP_TIMING"] = "1"
    timers = timing.reset()
    fallback.PATHS.clear()
    out = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    return rc, out.getvalue(), wall, _launches(), timers


def _truth_agreement(records, truth):
    from test_torch_fixtures import called_haplotypes

    agree = total = 0
    for rec in records:
        for sample, haps in called_haplotypes(rec).items():
            total += 1
            agree += haps == truth[rec["ID"]][sample]
    return agree, total


def c_dataset():
    """Phase C's synthetic dataset, written to ``.build/chip_smoke/assemble``
    (see ``phase_c``)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_fixtures import write_dataset

    from mchap_tpu_torch.constant import PFEIFFER_ERROR

    return write_dataset(
        WORK / "assemble", n_samples=22, n_loci=20,
        snvs_per_locus=[44] * 6 + [43] * 14,  # 866 in all
        ploidy=4, reads_per_sample=64, n_triallelic=5,
        error_rate=PFEIFFER_ERROR, n_founders=6, locus_length=300,
        founder_snvs=6, seed=2024,
    )


def phase_c(device, extra=(), label="C", out_name="out.vcf"):
    """``mchap assemble`` at default settings through the CLI entry point
    (phase P adds ``extra`` options).

    Synthetic dataset at the size of the reference's bundled bi-parental
    example: 22 tetraploid samples, 20 loci, 866 SNVs (5 triallelic),
    64 amplicon reads per sample and locus with base errors at the
    default rate, genotypes drawn from 6 founder haplotypes per locus
    that differ from the reference at 6 SNVs each.
    """
    from mchap_tpu_torch.utils import fallback

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_fixtures import parse_vcf_records

    n_loci = 20
    data = c_dataset()
    argv = [
        "mchap", "assemble", "--bam", *data["bams"], "--ploidy", "4",
        "--targets", data["targets"], "--variants", data["variants"],
        "--reference", data["reference"], *extra,
    ]
    rc, vcf, wall, launches, timers = _run_cli(argv)
    data["assembled"] = WORK / "assemble" / out_name
    data["assembled"].write_text(vcf)
    records = parse_vcf_records(vcf)
    agree, total = _truth_agreement(records, data["truth"])
    frac = agree / max(total, 1)
    k1 = launches["denovo_sampler"]
    # every de novo sampling ran K1: the port has no other sampler route
    routes = sorted(path for (site, path) in fallback.PATHS if site == "denovo")
    print(
        f"phase {label}: assemble{''.join(' ' + e for e in extra)} exit {rc}, {len(records)}"
        f" records, K1 launches {k1}, de novo routes {routes}, GT == truth"
        f" {agree}/{total} = {frac:.4f} (bound 0.90); wall {wall:.2f} s ="
        f" {n_loci / wall:.3f} loci/s",
        flush=True,
    )
    for line in timers.summary_lines():
        print(f"phase {label} timing:", line, flush=True)
    if (rc != 0 or len(records) != n_loci or k1 < 1 or routes != ["cuda"]
            or total != 440 or frac < 0.90):
        _fail(f"phase {label}")
    return launches, data


def _work(flops, transcendentals, nbytes):
    return dict(flops=float(flops), transcendentals=float(transcendentals),
                bytes=float(nbytes))


def _denovo_work(P, NB, A, R, S, C, T, trace_bytes, rungs=1, prior=False,
                 site_options=None):
    """K1 per launch of T steps, counted from denovo_sampler.cu: every
    site's candidate pass of the mutation sweep (per read and option: 10
    f32 operations, expf and log1pf; a 5-step butterfly per option), the
    other rows' logsumexp per row, and the interval sums of stage 2; with
    the prior, per option two more logf and six f32 operations; all of it
    once per rung, and per step each of the rungs - 1 swaps' four f32
    operations and expf.  Accepted moves, gated structural steps and
    their prior terms depend on the data and are left out.
    ``site_options`` (default NB * (A - 1)) is the mean over chains of
    the alternative alleles of their problem's positions."""
    opts = NB * (A - 1) if site_options is None else site_options
    per_step_flops = (
        P * opts * (10 * R + 5 * 32) + P * R * (3 * P - 2) + P * NB * R
    )
    per_step_tr = P * opts * 2 * R + P * R * P
    if prior:
        per_step_flops += P * opts * 6
        per_step_tr += P * opts * 2
    per_step_flops = per_step_flops * rungs + 4 * (rungs - 1)
    per_step_tr = per_step_tr * rungs + (rungs - 1)
    nbytes = (
        4 * (S * NB * A * R + S * R + S * NB + S + C + P * NB * C + T * C)
        + 4 * S * prior + trace_bytes * T * NB * C
    )
    return _work(per_step_flops * C * T, per_step_tr * C * T, nbytes)


def _calling_work(P, R, H, S, C, T, n_valid, problem):
    """K2 per launch, counted from calling_sampler.cu: per slot the other
    slots' e summed per read, then per valid candidate (a chain's
    problem's ``n_valid``; padding columns are never scored) and read an
    add, a logf, an add and a multiply-add, and per valid candidate two
    logf for the Gumbel draw and two operations; once per launch an expf
    per valid (problem, read, allele) and, per chain, log1pf of the P
    possible copy counts (a table the slots read)."""
    cols = n_valid.long()[problem.long()].sum().item()  # valid candidates over chains
    flops = P * (R * max(P - 2, 0) * C + cols * (4 * R + 2))
    tr = P * cols * (R + 2)
    once = R * n_valid.long().sum().item() + P * C
    nbytes = 4 * (S * R * H + S * R + S + C + T * C) + T * P * C
    return _work(flops * T, tr * T + once, nbytes)


def _mutation_work(P, NB, A, R, C):
    """K0 per launch: rh rebuilt from the genotype, then one mutation
    sweep counted as in ``_denovo_work``; bytes in the JAX layout."""
    flops = P * NB * R + P * NB * (A - 1) * (10 * R + 5 * 32) + P * R * (3 * P - 2)
    tr = P * NB * (A - 1) * 2 * R + P * R * P
    nbytes = 4 * (R * NB * A * C + R * C + 2 * P * NB * A * C + 2 * C + NB + P * R * C)
    return _work(flops * C, tr * C, nbytes)


def _bound(work, card):
    """Least time in ms, and whether bytes or operations set it."""
    t_bytes = work["bytes"] / 3.35e12
    t_ops = max(work["flops"] / 67e12, work["transcendentals"] / card["sfu_rate"],
                work.get("f64", 0.0) / 33.5e12)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


Q_TEMPS = [0.25, 0.5, 0.75, 1.0]


def k1_shape(label, device):
    """K1's inputs and options at a timing shape: "D" (16,384 chains, P4,
    NB16, A2, R64, 64 problems), "Q" (D's with 4 rungs and the prior at
    alpha 0.05) or "latency" (``LATENCY``, phase C's launches)."""
    import numpy as np
    import torch

    if label == "latency":
        return _latency_inputs(np.random.default_rng(5), device), {}
    args = _inputs(np.random.default_rng(7), 64, 4, 16, 2, 64, 16384, device)
    if label == "Q":
        return args, dict(temps=Q_TEMPS, alpha=torch.full((64,), 0.05, device=device))
    return args, {}


def time_k1(args, kw, steps=200, repeats=3):
    """K1's mean ms per step over ``repeats`` launches of ``steps`` steps,
    after a warm-up launch."""
    from mchap_tpu_torch.ops import cuda_denovo as K

    K.denovo_sampler(*args, n_steps=2, **kw)
    return _time_cuda(lambda: K.denovo_sampler(*args, n_steps=steps, seed=3, **kw),
                      repeats) / steps


def phase_d(device, card):
    """K1 and plain throughput at the de novo bench shape."""
    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, A, R, C, STEPS, S = 4, 16, 2, 64, 16384, 200, 64
    args, _ = k1_shape("D", device)
    k_ms = time_k1(args, {}, STEPS) * STEPS
    plain_steps = 20
    K.denovo_sampler_plain(*args, n_steps=1)
    p_ms = _time_cuda(
        lambda: K.denovo_sampler_plain(*args, n_steps=plain_steps, seed=3), 1
    )
    work = _denovo_work(P, NB, A, R, S, C, STEPS, 1)
    bound_ms, bound_by = _bound(work, card)
    print(
        f"phase D: {C} chains P{P} NB{NB} A{A} R{R}: kernel {k_ms:.1f} ms for"
        f" {STEPS} steps = {C * STEPS / (k_ms / 1e3):.4g} chain-steps/s; plain"
        f" {p_ms:.1f} ms for {plain_steps} steps ="
        f" {C * plain_steps / (p_ms / 1e3):.4g} chain-steps/s; bound"
        f" {bound_ms:.3f} ms by {bound_by} ({work['flops']:.3g} flops,"
        f" {work['transcendentals']:.3g} exp/log, {work['bytes']:.3g} bytes),"
        f" kernel at {bound_ms / k_ms:.2%} of it",
        flush=True,
    )
    return dict(ms=k_ms / STEPS, plain_ms=p_ms / plain_steps,
                bound_ms=bound_ms / STEPS, bound_by=bound_by)


def _calling_inputs(rng, S, P, H, R, C, device, NB=12, n_valid=None, adjacent=False):
    """Per-problem read x haplotype log-probabilities [S, R, H] of reads
    simulated from P of a random H-haplotype panel over NB SNVs.  With
    ``n_valid`` (cycled over the problems), problem s keeps its first
    n_valid[s] haplotypes and its other columns are MIN_LOG padding, as
    ``fit_calling_multi`` pads a block's panels to the largest.  Chain c
    belongs to problem c % S, or with ``adjacent`` to problem c // (C / S),
    as ``models/calling.py`` lays a problem's chains out."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops.likelihood import MIN_LOG, prepare_reads, read_hap_loglik
    from mchap_tpu_torch.testing import simulate_reads

    n_valid = np.resize(np.asarray(H if n_valid is None else n_valid, np.int32), S)
    rh = np.zeros((S, R, H), np.float32)
    for s in range(S):
        panel = rng.integers(0, 2, size=(H, NB))
        truth = panel[rng.choice(n_valid[s], P)]
        reads = simulate_reads(truth, n_alleles=2, n_reads=R, errors=True,
                               error_rate=0.0024, seed=int(rng.integers(1 << 30)))
        rh[s] = read_hap_loglik(prepare_reads(reads), panel).numpy()
        rh[s, :, n_valid[s]:] = MIN_LOG
    counts = rng.integers(1, 3, size=(S, R)).astype(np.float32)
    prob = np.repeat(np.arange(S), C // S) if adjacent else np.arange(C) % S
    return [torch.from_numpy(x).to(device)
            for x in (rh, counts, n_valid, prob.astype(np.int32))]


def _calling_recompute(alleles, rh, counts, prob, P):
    """f64 llk of every traced genotype: [n_steps, C]."""
    import torch

    rhc = rh.double()[prob.long()]  # [C, R, H]
    cnt = counts.double()[prob.long()]
    out = []
    for t in range(alleles.shape[0]):
        g = alleles[t].long().T  # [C, P]
        sel = torch.gather(rhc, 2, g[:, None, :].expand(-1, rhc.shape[1], -1))
        out.append(((torch.logsumexp(sel, 2) - torch.log(torch.tensor(float(P)))) * cnt).sum(1))
    return torch.stack(out)


def phase_e(device):
    """K2 vs plain on the card, same pinned noise: panels over 12 SNVs
    (distinct haplotypes, reads decide), over 3 SNVs (haplotypes
    repeat, so the chains keep moving between equal candidates), and
    over 12 SNVs with per-problem panels of 16, 13 and 7 haplotypes
    padded with MIN_LOG columns, as ``fit_calling_multi`` pads them."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_calling as KC

    P, H, R, S, C, STEPS = 4, 16, 64, 16, 1024, 300
    worst = 0.0
    for NB, nv in ((12, None), (3, None), (12, (H, H - 3, H - 9))):
        rng = np.random.default_rng(5 + NB + (nv is not None))
        rh, counts, n_valid, prob = _calling_inputs(
            rng, S, P, H, R, C, device, NB=NB, n_valid=nv
        )
        label = f"NB={NB}" + ("" if nv is None else ", n_valid " + "/".join(map(str, nv)))
        gen = torch.Generator(device=device)
        gen.manual_seed(NB)
        noise = torch.rand((STEPS, P, H, C), generator=gen, device=device).clamp_(min=1e-12)
        kw = dict(n_steps=STEPS, ploidy=P, noise=noise)
        g_k, l_k = KC.calling_sampler(rh, counts, n_valid, prob, **kw)
        g_p, l_p = KC.calling_sampler_plain(rh, counts, n_valid, prob, **kw)
        torch.cuda.synchronize()
        same = (g_k == g_p).all(dim=0).all(dim=0)
        frac = same.sum().item() / C  # exact: 1.0 only when every chain is
        err = (l_k - l_p).abs()[:, same].max().item()
        rec = _calling_recompute(g_k, rh, counts, prob, P)
        rec_err = (rec - l_k.double()).abs().max().item()
        moved = (g_k[1:] != g_k[:-1]).any(dim=1).float().mean().item()
        padded = (g_k.long() >= n_valid[prob.long()].long()).sum().item()
        print(
            f"phase E ({label}): K2 identical chains {frac:.4f} of {C} over"
            f" {STEPS} steps (P{P} H{H} R{R}, {S} problems); llk"
            f" |kernel-plain| on them {err:.3g} (bound 1e-3); llk vs f64"
            f" recompute {rec_err:.3g} (bound 1e-2); steps that changed the"
            f" genotype {moved:.3f}; padding alleles drawn {padded}",
            flush=True,
        )
        if frac < 1.0 or err > 1e-3 or rec_err > 1e-2 or padded:
            _fail(f"phase E ({label})")
        worst = max(worst, err)
    return worst


def phase_f(device):
    """K2 with in-kernel Philox vs exact enumeration (TV < 0.03): on the
    problem of scripts/gate_pallas_calling.py (4 haplotypes over 3 SNVs;
    a slot's Philox calls made during the step before), and on a panel
    of 33 haplotypes over 12 SNVs with reads from 3 of them (P *
    ceil(33 / 4) > 32, so each slot makes its calls in the slot).  On
    each, the first steps of the kernel's chains must also be the plain
    version's fed with ``cuda_calling.philox_noise``, the kernel's draws
    made on the host (bounds as phase E)."""
    import numpy as np
    import torch

    from mchap_tpu_torch.numerics.combinadics import genotype_alleles_as_index
    from mchap_tpu_torch.ops import cuda_calling as KC
    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik
    from mchap_tpu_torch.testing import simulate_reads

    P, C, STEPS, BURN, CHECK = 4, 1024, 3000, 500, 30
    rng = np.random.default_rng(31)
    wide = (rng.choice(1 << 12, 33, replace=False)[:, None] >> np.arange(12)) & 1
    cases = (
        ("H4", np.array([[0, 0, 0], [0, 1, 1], [1, 1, 0], [1, 1, 1]]), [0, 1, 1, 3], 13),
        ("H33", wide, [0, 1, 1, 2], (3 << 32) | 13),
    )
    worst = 0.0
    for label, panel, truth, seed in cases:
        panel = panel.astype(np.int8)
        reads = simulate_reads(panel[truth], n_alleles=2, n_reads=8, errors=False,
                               uniform_sample=True, qual=(20, 20), seed=7)
        want = exact.genotype_posteriors(exact.genotype_likelihoods(reads, P, panel)).numpy()
        rh = read_hap_loglik(prepare_reads(reads), panel).float()[None].to(device)
        args = (rh.contiguous(), torch.ones((1, rh.shape[1]), device=device),
                torch.tensor([len(panel)], dtype=torch.int32, device=device),
                torch.zeros(C, dtype=torch.int32, device=device))
        g, l = KC.calling_sampler(*args, n_steps=STEPS, ploidy=P, seed=seed)
        noise = KC.philox_noise(seed, CHECK, P, len(panel), C).to(device)
        g_p, l_p = KC.calling_sampler_plain(*args, n_steps=CHECK, ploidy=P, noise=noise)
        same = (g[:CHECK] == g_p).all(dim=0).all(dim=0)
        frac = same.sum().item() / C
        err = (l[:CHECK] - l_p).abs()[:, same].max().item() if same.any() else float("inf")
        flat = g[BURN:].permute(0, 2, 1).reshape(-1, P).long().cpu().numpy()
        got = np.bincount(genotype_alleles_as_index(flat), minlength=len(want)) / len(flat)
        tv = 0.5 * np.abs(got - want).sum()
        print(f"phase F ({label}, {len(want)} genotypes): TV(K2, exact) = {tv:.4f} (bound"
              f" 0.03); first {CHECK} steps vs the plain version on the kernel's Philox"
              f" draws: identical chains {frac:.4f}, llk |kernel-plain| {err:.3g}"
              f" (bounds 1.0, 1e-3)", flush=True)
        if not tv < 0.03 or frac < 1.0 or err > 1e-3:
            _fail(f"phase F ({label})")
        worst = max(worst, tv)
    return worst


@contextlib.contextmanager
def _k2_launch_shapes():
    """Record the shape of every K2 call made by ``models/calling.py``:
    S, chains per problem, P, the read bucket R, the padded panel width
    H, the per-problem ``n_valid`` as (value, run) pairs, and whether a
    problem's chains are adjacent."""
    import torch

    from mchap_tpu_torch.models import calling as M

    seen, real = [], M.calling_sampler

    def spy(rh, counts, n_valid, problem, **kw):
        S, R, H = rh.shape
        chains = problem.numel() // S
        runs = []
        for v in n_valid.tolist():
            if runs and runs[-1][0] == v:
                runs[-1][1] += 1
            else:
                runs.append([v, 1])
        adjacent = bool((problem.cpu() == torch.arange(S, dtype=torch.int32)
                         .repeat_interleave(chains)).all())
        seen.append(dict(S=S, chains=chains, P=kw["ploidy"], R=R, H=H,
                         n_valid=tuple(map(tuple, runs)), adjacent=adjacent))
        return real(rh, counts, n_valid, problem, **kw)

    M.calling_sampler = spy
    try:
        yield seen
    finally:
        M.calling_sampler = real


def phase_g(device, data, extra=()):
    """``mchap call`` at default settings through the CLI entry point:
    phase C's reads, with phase C's output VCF as the haplotype panel
    (MCHap's documented two-step workflow).  Prints the shape of its K2
    launch and fails unless it is the one launch ``LATENCY_K2`` fixes for
    phase V."""
    from test_torch_fixtures import parse_vcf_records

    n_loci = 20
    argv = [
        "mchap", "call", "--bam", *data["bams"], "--ploidy", "4",
        "--haplotypes", str(data["assembled"]), "--reference", data["reference"],
        *extra,
    ]
    with _k2_launch_shapes() as shapes:
        rc, vcf, wall, launches, timers = _run_cli(argv)
    (WORK / "assemble" / "call.vcf").write_text(vcf)
    records = parse_vcf_records(vcf)
    agree, total = _truth_agreement(records, data["truth"])
    frac = agree / max(total, 1)
    incomplete = sum(
        "." in c["GT"]
        for rec in records if rec["FILTER"] == "PASS"
        for c in rec["calls"].values()
    )
    k2 = launches["calling_sampler"]
    print(
        f"phase G: call exit {rc}, {len(records)} records, K2 launches {k2},"
        f" GT with '.' in PASS records {incomplete}, GT == truth"
        f" {agree}/{total} = {frac:.4f} (bound 0.90); wall {wall:.2f} s ="
        f" {n_loci / wall:.3f} loci/s",
        flush=True,
    )
    for line in timers.summary_lines():
        print("phase G timing:", line, flush=True)
    for shape in shapes:
        print(f"phase G K2 launch: {json.dumps(shape)}", flush=True)
    if shapes != [LATENCY_K2]:  # phase V times this launch's shape
        print(f"phase G: K2 launches differ from LATENCY_K2 {json.dumps(LATENCY_K2)}",
              flush=True)
    if (rc != 0 or len(records) != n_loci or k2 < 1 or incomplete
            or total != 440 or frac < 0.90 or shapes != [LATENCY_K2]):
        _fail("phase G")
    return launches


def k2_shape(label, device):
    """K2's inputs and ploidy at a timing shape: "H" (65,536 chains, P4,
    R64, a 16-haplotype panel, 64 problems, chain c on problem c % 64) or
    "V" (``LATENCY_K2``, phase G's launch; panels over 12 SNVs, so that
    haplotypes differ at a few SNVs as phase C's founders do and every
    candidate's e stays above f32's underflow)."""
    import numpy as np

    if label == "V":
        L = LATENCY_K2
        n_valid = np.repeat(*np.array(L["n_valid"]).T)
        args = _calling_inputs(np.random.default_rng(23), L["S"], L["P"], L["H"], L["R"],
                               L["S"] * L["chains"], device, n_valid=n_valid,
                               adjacent=L["adjacent"])
        return args, L["P"]
    return _calling_inputs(np.random.default_rng(11), 64, 4, 16, 64, 65536, device), 4


def time_k2(args, P, steps=500, repeats=3):
    """K2's mean ms per step over ``repeats`` launches of ``steps`` steps,
    after a warm-up call through the wrapper, which checks the inputs.
    The timed launches go through ``_launch``, past those checks: they
    wait for the card, so through the wrapper the window would hold each
    call's host side (phase V prints it)."""
    from mchap_tpu_torch.ops import cuda_calling as KC

    KC.calling_sampler(*args, n_steps=2, ploidy=P)
    return _time_cuda(lambda: KC._launch(*args, n_steps=steps, ploidy=P, seed=3, noise=None),
                      repeats) / steps


def phase_h(device, card):
    """K2 and plain throughput at the calling bench shape."""
    from mchap_tpu_torch.ops import cuda_calling as KC

    STEPS = 500
    args, P = k2_shape("H", device)
    S, R, H = args[0].shape
    C = args[3].shape[0]
    k_ms = time_k2(args, P, STEPS) * STEPS
    plain_steps = 5
    KC.calling_sampler_plain(*args, n_steps=1, ploidy=P)
    p_ms = _time_cuda(
        lambda: KC.calling_sampler_plain(*args, n_steps=plain_steps, ploidy=P, seed=3), 1
    )
    work = _calling_work(P, R, H, S, C, STEPS, args[2], args[3])
    bound_ms, bound_by = _bound(work, card)
    print(
        f"phase H: K2 {C} chains P{P} R{R} H{H} over {S} problems: kernel"
        f" {k_ms:.1f} ms for {STEPS} steps = {C * STEPS / (k_ms / 1e3):.4g}"
        f" chain-steps/s; plain {p_ms:.1f} ms for {plain_steps} steps ="
        f" {C * plain_steps / (p_ms / 1e3):.4g} chain-steps/s; bound"
        f" {bound_ms:.3f} ms by {bound_by} ({work['flops']:.3g} flops,"
        f" {work['transcendentals']:.3g} exp/log, {work['bytes']:.3g} bytes),"
        f" kernel at {bound_ms / k_ms:.2%} of it",
        flush=True,
    )
    return dict(ms=k_ms / STEPS, plain_ms=p_ms / plain_steps,
                bound_ms=bound_ms / STEPS, bound_by=bound_by)


def _k2_vs_plain(args, P, steps, seed):
    """K2 and its plain version on the same pinned noise: (fraction of
    identical chains, max llk difference on them)."""
    import torch

    from mchap_tpu_torch.ops import cuda_calling as KC

    H, C = args[0].shape[2], args[3].shape[0]
    gen = torch.Generator(device=args[0].device)
    gen.manual_seed(seed)
    noise = torch.rand((steps, P, H, C), generator=gen, device=args[0].device)
    kw = dict(n_steps=steps, ploidy=P, noise=noise.clamp_(min=1e-12))
    g_k, l_k = KC.calling_sampler(*args, **kw)
    g_p, l_p = KC.calling_sampler_plain(*args, **kw)
    torch.cuda.synchronize()
    same = (g_k == g_p).all(dim=0).all(dim=0)
    err = (l_k - l_p).abs()[:, same].max().item() if same.any() else float("inf")
    return same.sum().item() / C, err  # exact: 1.0 only when every chain is


def phase_v(device, card, STEPS=2000, CHECK=30):
    """K2 at the latency shape of phase G's launch (``LATENCY_K2``):
    kernel vs plain on its first ``CHECK`` steps, pinned noise (bounds as
    phase E), then both timed (the kernel by ``time_k2``, past the
    wrapper's checks; a 1-step call through the wrapper is timed too, as
    the size of the host side that leaves out)."""
    from mchap_tpu_torch.ops import cuda_calling as KC

    args, P = k2_shape("V", device)
    S, R, H = args[0].shape
    C = args[3].shape[0]
    frac, err = _k2_vs_plain(args, P, CHECK, seed=29)
    k_ms = time_k2(args, P, STEPS)
    call_ms = _time_cuda(lambda: KC.calling_sampler(*args, n_steps=1, ploidy=P, seed=3), 3)
    plain_steps = 5
    KC.calling_sampler_plain(*args, n_steps=1, ploidy=P)
    p_ms = _time_cuda(
        lambda: KC.calling_sampler_plain(*args, n_steps=plain_steps, ploidy=P, seed=3), 1
    ) / plain_steps
    work = _calling_work(P, R, H, S, C, STEPS, args[2], args[3])
    bound_ms, bound_by = _bound(work, card)
    print(
        f"phase V: K2 {C} chains ({S} problems x {C // S}) P{P} R{R} H{H} n_valid"
        f" {LATENCY_K2['n_valid']}: identical chains {frac:.4f} over {CHECK} steps, llk"
        f" |kernel-plain| on them {err:.3g} (bounds 1.0, 1e-3); kernel {k_ms:.5f} ms per"
        f" step = {C / (k_ms / 1e3):.4g} chain-steps/s over launches of {STEPS} steps"
        f" (a 1-step call through the wrapper, its input checks included, {call_ms:.4f}"
        f" ms); plain {p_ms:.3f} ms per step;"
        f" bound {bound_ms / STEPS:.6f} ms per step by {bound_by}, kernel at"
        f" {bound_ms / STEPS / k_ms:.2%} of it",
        flush=True,
    )
    if frac < 1.0 or err > 1e-3:
        _fail("phase V")
    return dict(latency_ms=k_ms, latency_plain_ms=p_ms, latency_bound_ms=bound_ms / STEPS,
                latency_bound_by=bound_by, latency_max_abs_err=err)


def _mutation_inputs(rng, P, NB, A, R, C, device):
    """K0's inputs in the JAX layout (chains last), with each chain's
    current llk recomputed from its genotype."""
    import numpy as np
    import torch

    S = 16
    lr = _problems(rng, S, P, NB, A, R)  # [S, NB, A, R]
    prob = np.arange(C) % S
    lr_cl = np.ascontiguousarray(lr[prob].transpose(3, 1, 2, 0))  # [R, NB, A, C]
    g = rng.integers(0, A, size=(P, NB, C))
    onehot = np.ascontiguousarray(np.eye(A, dtype=np.float32)[g].transpose(0, 1, 3, 2))
    counts = np.ones((R, C), np.float32)
    rows = np.take_along_axis(lr_cl[None], g[:, None, :, None, :], axis=3)[:, :, :, 0]
    rows = rows.astype(np.float64).sum(axis=2)  # [P, R, C]
    m = rows.max(axis=0)
    llk = (m + np.log(np.exp(rows - m).sum(axis=0)) - np.log(P)).sum(axis=0)
    nall = np.full(NB, A, np.int32)
    return [
        torch.from_numpy(x).to(device)
        for x in (nall, lr_cl, counts, onehot, llk.astype(np.float32))
    ]


def phase_i(device, card):
    """K0 vs plain on the card with pinned noise, then one sweep timed."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, R, TEMP = 4, 16, 64, 0.5
    worst = 0.0
    for A in (2, 3):
        C = 1024
        args = _mutation_inputs(np.random.default_rng(30 + A), P, NB, A, R, C, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(A)
        noise = torch.rand((P * NB, C), generator=gen, device=device).clamp_(min=1e-12)
        g_k, rh_k, l_k = K.mutation_sweep(0, *args, TEMP, noise=noise)
        g_p, rh_p, l_p = K.mutation_sweep_plain(0, *args, TEMP, noise=noise)
        torch.cuda.synchronize()
        same = (g_k == g_p).flatten(0, 2).all(dim=0)
        frac = same.float().mean().item()
        err = max(
            (rh_k - rh_p).abs()[:, :, same].max().item(),
            (l_k - l_p).abs()[same].max().item(),
        )
        moved = (g_k != args[3]).flatten(0, 2).any(dim=0).float().mean().item()
        print(
            f"phase I (A={A}): K0 identical genotypes {frac:.4f} of {C} chains"
            f" (P{P} NB{NB} R{R}, temp {TEMP}); rh/llk |kernel-plain| on them"
            f" {err:.3g} (bound 1e-3); chains that moved {moved:.3f}",
            flush=True,
        )
        if frac < 0.99 or err > 1e-3:
            _fail(f"phase I (A={A})")
        worst = max(worst, err)
    A, C = 2, 16384
    args = _mutation_inputs(np.random.default_rng(40), P, NB, A, R, C, device)
    K.mutation_sweep(1, *args, TEMP)  # warm-up
    k_ms = _time_cuda(lambda: K.mutation_sweep(1, *args, TEMP), 10)
    K.mutation_sweep_plain(1, *args, TEMP)
    p_ms = _time_cuda(lambda: K.mutation_sweep_plain(1, *args, TEMP), 1)
    work = _mutation_work(P, NB, A, R, C)
    bound_ms, bound_by = _bound(work, card)
    print(
        f"phase I: K0 one sweep of {C} chains P{P} NB{NB} A{A} R{R}: kernel"
        f" {k_ms:.3f} ms (layout changes included), plain {p_ms:.1f} ms; bound"
        f" {bound_ms:.4f} ms by {bound_by}, kernel at {bound_ms / k_ms:.2%} of it",
        flush=True,
    )
    return worst, dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)


BIPARENTAL = [[-1, -1], [-1, -1]] + [[0, 1]] * 20
SELFED = [[-1, -1], [0, 0], [0, 0], [1, 1], [-1, -1], [0, 4]]
BACKCROSS = [[-1, -1], [-1, -1], [0, 1], [0, 2], [2, 1], [0, 2]]
MIXED = [[-1, -1], [-1, -1], [0, 1], [0, 1], [2, 1]]  # ploidies 4, 2, 3, 3, 2
MIXED_PLOIDY = [4, 2, 3, 3, 2]
MIXED_TAU = [[2, 2], [1, 1], [2, 1], [2, 1], [1, 1]]
# two founders, six F1, eight F2 from F1 pairs, one F2 backcrossed to a
# founder: short waves that interleave with their parents
THREE_GEN = ([[-1, -1], [-1, -1]] + [[0, 1]] * 6
             + [[2, 3], [2, 3], [4, 5], [4, 5], [6, 7], [6, 7], [3, 4], [5, 6]] + [[8, 0]])


def _pedigree_inputs(rng, parents, n_loci, device, ploidy=None, tau=None, H=16, NB=16,
                     R=64):
    """K3's per-locus inputs for one pedigree: reads simulated from each
    sample's genotype (founders draw their ploidy of an H-haplotype panel
    over NB SNVs, children tau of each parent's haplotypes; tetraploids
    and 2 + 2 by default), rh f32[N, S, R, H], counts f32[N, S, R],
    random frequencies f64[N, H], n_valid i32[N]."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik
    from mchap_tpu_torch.testing import simulate_reads

    parents = np.asarray(parents)
    S = len(parents)
    ploidy = np.full(S, 4) if ploidy is None else np.asarray(ploidy)
    tau = np.full((S, 2), 2) if tau is None else np.asarray(tau)
    rh = np.zeros((n_loci, S, R, H), np.float32)
    for n in range(n_loci):
        panel = rng.integers(0, 2, size=(H, NB))
        geno = []
        for i, (a, b) in enumerate(parents):
            if a < 0:
                geno.append(rng.integers(0, H, ploidy[i]))
            else:
                geno.append(np.concatenate([rng.choice(geno[a], tau[i, 0], replace=False),
                                            rng.choice(geno[b], tau[i, 1], replace=False)]))
            reads = simulate_reads(panel[geno[i]], n_alleles=2, n_reads=R, errors=True,
                                   error_rate=0.0024, seed=int(rng.integers(1 << 30)))
            rh[n, i] = read_hap_loglik(prepare_reads(reads), panel).numpy()
    freqs = rng.dirichlet(np.ones(H), size=n_loci)
    nv = np.full(n_loci, H, np.int32)
    counts = rng.integers(1, 3, size=(n_loci, S, R)).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (rh, counts, freqs, nv)]


def _pedigree_plan(parents, ploidy=None, tau=None, err=0.1):
    import numpy as np

    from mchap_tpu_torch.ops import cuda_pedigree as K3

    S = len(parents)
    return K3.Plan(np.full(S, 4) if ploidy is None else np.asarray(ploidy),
                   np.asarray(parents), np.full((S, 2), 2) if tau is None else np.asarray(tau),
                   np.zeros((S, 2)), np.full((S, 2), err))


def phase_j(device):
    """K3 vs its plain version on the card with the same pinned noise:
    the bi-parental tetraploid pedigree (2 + 20, H16, R64) over 4 loci x
    64 chains, with 16 SNVs (reads decide) and with 3 (haplotypes repeat,
    so the chains keep moving), then pedigrees with selfed samples, with
    backcrosses, with mixed ploidies, over three generations and of
    hexaploids (the kernel's P <= 6 instance)."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_pedigree as K3

    worst = 0
    for name, parents, loci, chains, steps, nb, ploidy, tau in (
        ("bi-parental 2+20", BIPARENTAL, 4, 64, 20, 16, None, None),
        ("bi-parental 2+20, 3 SNVs", BIPARENTAL, 4, 64, 20, 3, None, None),
        ("selfed, 3 SNVs", SELFED, 2, 64, 60, 3, None, None),
        ("backcross, 3 SNVs", BACKCROSS, 2, 64, 60, 3, None, None),
        ("mixed ploidy 4/2/3, 3 SNVs", MIXED, 2, 64, 60, 3, MIXED_PLOIDY, MIXED_TAU),
        ("three generations, 3 SNVs", THREE_GEN, 2, 64, 40, 3, None, None),
        ("hexaploid 2+6, 3 SNVs", BIPARENTAL[:8], 2, 64, 40, 3, [6] * 8, [[3, 3]] * 8),
    ):
        rng = np.random.default_rng(len(parents) + steps + nb)
        rh, counts, freqs, nv = _pedigree_inputs(rng, parents, loci, device, ploidy, tau,
                                                 NB=nb)
        plan = _pedigree_plan(parents, ploidy, tau)
        C = loci * chains
        S, maxp, H = plan.n_samples, plan.max_ploidy, rh.shape[-1]
        prob = torch.arange(loci, dtype=torch.int32, device=device).repeat_interleave(chains)
        init = rng.integers(0, H, (C, S, maxp)).astype(np.int32)
        init[:, np.arange(maxp)[None, :] >= plan.ploidy[:, None]] = -1
        init = torch.from_numpy(init).to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(S)
        noise = torch.rand((steps, plan.n_draws(H), C), generator=gen,
                           device=device).clamp_(min=1e-12)
        args = (rh, counts, freqs, nv, prob, init, plan)
        t_k = K3.pedigree_sampler(*args, n_steps=steps, noise=noise)
        with torch.inference_mode():  # less dispatch work per plain-version op
            t_p = K3.pedigree_sampler_plain(*args, n_steps=steps, noise=noise)
        torch.cuda.synchronize()
        same = (t_k == t_p).flatten(1).all(1)
        frac = same.float().mean().item()
        err = (t_k.long() - t_p.long()).abs().max().item()
        states = torch.cat([init[:, None].to(t_k.dtype), t_k], 1)
        moved = (states[:, 1:] != states[:, :-1]).flatten(2).any(2).float().mean().item()
        print(
            f"phase J ({name}): K3 identical chains {frac:.4f} of {C} over {steps}"
            f" steps ({S} samples P{maxp} H{H} R{rh.shape[2]}, {loci} loci,"
            f" {len(plan.waves)} waves);"
            f" max |allele kernel - plain| {err}; steps that changed a genotype"
            f" {moved:.3f}", flush=True,
        )
        if frac < 1.0:
            _fail(f"phase J ({name})")
        worst = max(worst, err)
    return float(worst)


def phase_k(device):
    """K3 with its own Philox stream vs exact enumeration of the joint
    (TV <= 0.02 per sample): the two scenarios of
    scripts/gate_pallas_pedigree.py at 3x their steps, and a selfed trio."""
    import numpy as np
    import torch

    from mchap_tpu_torch.models.pedigree import _sort_roll_trace
    from mchap_tpu_torch.numerics.combinadics import genotype_alleles_as_index
    from mchap_tpu_torch.ops import cuda_pedigree as K3
    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik
    from mchap_tpu_torch.testing import exact_pedigree_marginals, simulate_reads

    haps = np.array([[0, 0], [0, 1], [1, 1]], dtype=np.int8)
    worst = 0.0
    for name, ploidy, tau_child, parents in (
        ("trio", 2, (1, 1), [[-1, -1], [-1, -1], [0, 1]]),
        ("tau31", 4, (3, 1), [[-1, -1], [-1, -1], [0, 1]]),
        ("selfed trio", 2, (1, 1), [[-1, -1], [-1, -1], [0, 0]]),
    ):
        parents = np.asarray(parents)
        tau = np.full((3, 2), max(ploidy // 2, 1))
        tau[2] = tau_child
        lam, err = np.zeros((3, 2)), np.full((3, 2), 0.01)
        rng = np.random.default_rng(3)
        truths = [haps[rng.integers(0, 3, ploidy)] for _ in range(3)]
        reads = [simulate_reads(t_, n_alleles=2, n_reads=4, qual=(14, 18), seed=i)
                 for i, t_ in enumerate(truths)]
        llks = np.stack([exact.genotype_likelihoods(r, ploidy, haps).numpy() for r in reads])
        want = exact_pedigree_marginals(llks, parents, tau, lam, err, 3, ploidy)
        plan = K3.Plan(np.full(3, ploidy), parents, tau, lam, err)
        rh = torch.stack([read_hap_loglik(prepare_reads(r), haps) for r in reads])
        C, STEPS, BURN = 64, 9000, 1500
        trace = K3.pedigree_sampler(
            rh[None].float().contiguous().to(device), torch.ones((1, 3, 4), device=device),
            torch.full((1, 3), 1 / 3, dtype=torch.float64, device=device),
            torch.tensor([3], dtype=torch.int32, device=device),
            torch.zeros(C, dtype=torch.int32, device=device),
            torch.zeros((C, 3, ploidy), dtype=torch.int32, device=device), plan,
            n_steps=STEPS, seed=17,
        )
        g = _sort_roll_trace(trace[:, BURN:].cpu().numpy().astype(np.int64),
                             np.full(3, ploidy), ploidy)
        tvs = []
        for i in range(3):
            idx = genotype_alleles_as_index(g[:, :, i].reshape(-1, ploidy))
            got = np.bincount(idx, minlength=want.shape[1]) / idx.size
            tvs.append(0.5 * np.abs(got - want[i]).sum())
        print(f"phase K ({name}): TV(K3, exact) per sample"
              f" {', '.join(f'{x:.4f}' for x in tvs)} (bound 0.02; {C} chains x"
              f" {STEPS} steps, burn {BURN})", flush=True)
        if max(tvs) > 0.02:
            _fail(f"phase K ({name})")
        worst = max(worst, max(tvs))
    return worst


def phase_l(device, extra=()):
    """``mchap call-pedigree`` at default settings through the CLI entry
    point, on a synthetic dataset of the reference example's design: 2
    tetraploid parents + 20 Mendelian progeny, 20 loci, 64 reads per
    sample and locus, the parents' haplotype pool as the panel."""
    from test_torch_fixtures import parse_vcf_records, write_dataset, write_haplotype_vcf

    from mchap_tpu_torch.constant import PFEIFFER_ERROR
    from mchap_tpu_torch.utils import fallback

    n_loci = 20
    data = write_dataset(
        WORK / "pedigree", n_samples=22, n_loci=n_loci, snvs_per_locus=[44] * 6 + [43] * 14,
        ploidy=4, reads_per_sample=64, n_triallelic=5, error_rate=PFEIFFER_ERROR,
        n_founders=6, locus_length=300, founder_snvs=6, pedigree=True, seed=2025,
    )
    panel = write_haplotype_vcf(WORK / "pedigree" / "panel.vcf", data)
    argv = [
        "mchap", "call-pedigree", "--bam", *data["bams"], "--ploidy", "4",
        "--haplotypes", panel, "--reference", data["reference"],
        "--sample-parents", data["pedigree"], *extra,
    ]
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the tool is experimental
        rc, vcf, wall, launches, timers = _run_cli(argv)
    torch_route = fallback.PATHS[("pedigree", "torch")]
    (WORK / "pedigree" / "out.vcf").write_text(vcf)
    records = parse_vcf_records(vcf)
    agree, total = _truth_agreement(records, data["truth"])
    frac = agree / max(total, 1)
    incomplete = sum(
        "." in c["GT"] for rec in records if rec["FILTER"] == "PASS"
        for c in rec["calls"].values()
    )
    k3 = launches["pedigree_sampler"]
    print(
        f"phase L: call-pedigree exit {rc}, {len(records)} records, K3 launches {k3},"
        f" torch-sampler runs {torch_route}, GT with '.' in PASS records"
        f" {incomplete}, GT == truth {agree}/{total} = {frac:.4f} (bound 0.90);"
        f" wall {wall:.2f} s = {n_loci / wall:.3f} loci/s", flush=True,
    )
    for line in timers.summary_lines():
        print("phase L timing:", line, flush=True)
    if (rc != 0 or len(records) != n_loci or k3 < 1 or torch_route or incomplete
            or total != 440 or frac < 0.90):
        _fail("phase L")
    return launches


def _pedigree_work(plan, N, R, H, C, T):
    """K3 per launch, counted from pedigree_sampler.cu.  Per slot update:
    each read's rest (P - 1 expf and a logf, 2P f32 operations), then per
    candidate and read expf and log1pf with 4 f32 and 3 f64 operations,
    per candidate two f64 logs (counted as 20 f64 operations each) and
    the trio of the sample and each child, counted as its D branch alone
    (4P f64 operations; the gamete rows depend on the data and are left
    out).  Per pair: both samples' read terms and two trios per blanket
    member.  Bytes: every input once and the int16 trace."""
    flops = tr = f64 = 0
    for s in range(plan.n_samples):
        P = int(plan.ploidy[s])
        trios = 1 + len(plan.children[s])
        tr += P * (R * P + 2 * R * H)
        flops += P * (2 * R * P + 4 * R * H)
        f64 += P * (3 * R * H + H * (40 + 4 * P * trios + 3))
    for (p, q), blanket in zip(plan.pairs, plan.blankets):
        for s in (p, q):
            P = int(plan.ploidy[s])
            tr += R * (P + 4)
            f64 += 3 * R
        f64 += sum(8 * int(plan.ploidy[x]) for x in blanket)
    S, maxp = plan.n_samples, plan.max_ploidy
    nbytes = (4 * N * S * R * H + 4 * N * S * R + 8 * N * H + 4 * N + 4 * C
              + 4 * C * S * maxp + 2 * C * T * S * maxp)
    work = _work(flops * C * T, tr * C * T, nbytes)
    work["f64"] = float(f64 * C * T)
    return work


def phase_m(device, card):
    """K3 alone at the TPU-era pedigree bench shape (bench.py:168-234):
    22-sample bi-parental pedigree, P4, R64, 16 haplotypes over 16 SNVs,
    gamete error 0.1, 128 loci x 1 chain x 500 steps; then 128 loci x
    128 chains x 50 steps to fill the card."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_pedigree as K3

    rng = np.random.default_rng(23)
    N, R, H = 128, 64, 16
    rh, counts, freqs, nv = _pedigree_inputs(rng, BIPARENTAL, N, device)
    plan = _pedigree_plan(BIPARENTAL)
    S, maxp = plan.n_samples, plan.max_ploidy
    print(f"phase M: {len(plan.waves)} waves of {[len(w) for w in plan.waves]} samples",
          flush=True)
    out = None
    for chains, steps in ((1, 500), (128, 50)):
        C = N * chains
        warps = K3.launch_warps(plan, C, R, device)
        prob = torch.arange(N, dtype=torch.int32, device=device).repeat_interleave(chains)
        init = torch.from_numpy(rng.integers(0, H, (C, S, maxp)).astype(np.int32)).to(device)
        args = (rh, counts, freqs, nv, prob, init, plan)
        K3.pedigree_sampler(*args, n_steps=2)  # warm-up
        k_ms = _time_cuda(lambda: K3.pedigree_sampler(*args, n_steps=steps, seed=5), 2)
        plain_steps = 2
        K3.pedigree_sampler_plain(*args, n_steps=1)
        p_ms = _time_cuda(
            lambda: K3.pedigree_sampler_plain(*args, n_steps=plain_steps, seed=5), 1
        )
        work = _pedigree_work(plan, N, R, H, C, steps)
        bound_ms, bound_by = _bound(work, card)
        print(
            f"phase M: K3 {N} loci x {chains} chains ({S} samples P{maxp} R{R} H{H},"
            f" {warps} warps per chain's block):"
            f" kernel {k_ms:.1f} ms for {steps} steps = {C * steps / (k_ms / 1e3):.4g}"
            f" compound chain-steps/s; plain {p_ms:.1f} ms for {plain_steps} steps ="
            f" {C * plain_steps / (p_ms / 1e3):.4g} chain-steps/s; bound"
            f" {bound_ms:.3f} ms by {bound_by} ({work['flops']:.3g} f32 operations,"
            f" {work['transcendentals']:.3g} expf/logf, {work['f64']:.3g} f64"
            f" operations, {work['bytes']:.3g} bytes), kernel at"
            f" {bound_ms / k_ms:.2%} of it", flush=True,
        )
        if out is None:
            out = dict(ms=k_ms / steps, plain_ms=p_ms / plain_steps,
                       bound_ms=bound_ms / steps, bound_by=bound_by)
    return out


TEMPERED_DIRMUL = ["--mcmc-temperatures", "0.5", "1.0", "--use-dirmul-prior", "0.1"]
PHASE_P_ALPHAS = "phase P's"
MODES = (
    # (label, ladder, alpha, chains): phase N's tempered and prior modes.
    # T = 2 is phase P's ladder, the one layout with two chains per block.
    ("T=3 flat", [0.33, 0.66, 1.0], None, 1024),
    ("T=1 alpha 0.05", None, 0.05, 1024),
    ("T=3 alpha 0.05", [0.33, 0.66, 1.0], 0.05, 1024),
    ("T=2 flat", [0.5, 1.0], None, 2048),
    ("T=2 alphas 9/A^n", [0.5, 1.0], PHASE_P_ALPHAS, 2048),
)


def _phase_p_alphas(S, A):
    """Per-problem dispersions at phase P's size: ``models/assemble.py``
    gives (1 - F) / F over the product of the allele counts of the
    heterozygous positions, here F = 0.1 and 4..16 positions of A
    alleles (9/2^16 = 1.4e-4 at A = 2)."""
    return [(1 - 0.1) / 0.1 / A ** (4 + s % 13) for s in range(S)]


def phase_n(device, STEPS=200):
    """K1 vs its plain version in its tempered and Dirichlet-multinomial
    modes, same pinned noise, bounds as phase A.

    Each problem's 64 reads come from two distinct haplotypes (an inbred
    sample) at 15% base error.  Only there does the prior decide moves:
    it weighs rows that are equal over every position, which random
    haplotypes over 16 SNVs seldom give, and sharp reads outweigh it.
    So each prior mode also runs the kernel without the prior on the
    same noise and fails unless some chain's trace differs."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, R, S = 4, 16, 64, 16
    worst = 0.0
    for label, temps, alpha, C in MODES:
        for A in (2, 3):
            rng = np.random.default_rng(200 + A)
            args = _inputs(rng, S, P, NB, A, R, C, device, error_rate=0.15, n_distinct=2)
            seed = A + 10 * (1 if temps is None else len(temps))
            if alpha == PHASE_P_ALPHAS:
                alpha_t = torch.tensor(_phase_p_alphas(S, A), device=device)
            else:
                alpha_t = None if alpha is None else torch.full((S,), alpha, device=device)
            frac, err, t_k, l_k = _kernel_vs_plain(args, STEPS, seed, temps, alpha_t)
            rec = _recompute_llks(t_k, args[0], args[5], P, A)
            rec_err = (rec - l_k.double()).abs().max().item()
            moved = (t_k[1:] != t_k[:-1]).any(dim=1).float().mean().item()
            by_prior = 1.0
            if alpha_t is not None:
                t_f, _ = K.denovo_sampler(*args, n_steps=STEPS, temps=temps,
                                          noise=_pinned_noise(args, STEPS, seed, temps))
                by_prior = (t_k != t_f).any(dim=0).any(dim=0).float().mean().item()
            print(
                f"phase N ({label}, A={A}): identical chains {frac:.4f} of {C} over"
                f" {STEPS} steps; llk |kernel-plain| on them {err:.3g} (bound 1e-3);"
                f" cold llk vs recompute {rec_err:.3g} (bound 1e-2); steps that"
                f" changed the cold genotype {moved:.3f}"
                + (f"; chains the prior changed {by_prior:.3f} (bound > 0)"
                   if alpha_t is not None else ""),
                flush=True,
            )
            if frac < 0.99 or err > 1e-3 or rec_err > 1e-2 or by_prior == 0:
                _fail(f"phase N ({label}, A={A})")
            worst = max(worst, err)
    return worst


def _gate_problem(n_reads, qual):
    """P4 over 2 biallelic SNVs: reads of scripts/gate_pallas_denovo.py's
    genotype, the exact log likelihood of every genotype over the four
    haplotypes, and the read tensor K1 takes."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops.likelihood import prepare_reads
    from mchap_tpu_torch.testing import simulate_reads

    haplotypes = np.array([[0, 0], [0, 1], [1, 1], [0, 0]], np.int8)
    reads = simulate_reads(
        haplotypes, n_alleles=2, n_reads=n_reads, errors=False, uniform_sample=True,
        qual=qual, seed=11,
    )
    panel = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)
    llks = exact.genotype_likelihoods(reads, 4, panel)
    lr = prepare_reads(reads, dtype=torch.float32).permute(1, 2, 0)[None].contiguous()
    return llks, lr


def phase_o(device, C=1024, STEPS=1500, BURN=300):
    """K1 with its own Philox stream vs exact enumeration (TV < 0.03) in
    the tempered and prior modes: the gate problem with ladder [0.33,
    0.66, 1.0], with the prior at F = 0.3, and with both; then at 6 reads
    of quality 12-16 and F = 0.5, where the prior moves the posterior."""
    import numpy as np
    import torch

    from mchap_tpu_torch.numerics.combinadics import (
        enumerate_genotypes,
        genotype_alleles_as_index,
    )
    from mchap_tpu_torch.ops import cuda_denovo as K
    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops.priors import log_genotype_prior

    P, NB, A = 4, 2, 2
    ladder = [0.33, 0.66, 1.0]
    table = torch.tensor(enumerate_genotypes(4, P))
    worst = 0.0
    for label, n_reads, qual, temps, F in (
        ("tempered", 8, (20, 20), ladder, None),
        ("prior F=0.3", 8, (20, 20), None, 0.3),
        ("both F=0.3", 8, (20, 20), ladder, 0.3),
        ("prior F=0.5, 6 reads", 6, (12, 16), None, 0.5),
        ("both F=0.5, 6 reads", 6, (12, 16), ladder, 0.5),
    ):
        llks, lr = _gate_problem(n_reads, qual)
        flat = exact.genotype_posteriors(llks).numpy()
        want = flat if F is None else exact.genotype_posteriors(
            llks + log_genotype_prior(table, 4, inbreeding=F)).numpy()
        rng = np.random.default_rng(0)
        trace, _ = K.denovo_sampler(
            lr.to(device), torch.ones((1, lr.shape[-1]), device=device),
            torch.from_numpy(rng.integers(0, A, size=(P, NB, C)).astype(np.int32)).to(device),
            torch.full((1, NB), A, dtype=torch.int32, device=device),
            torch.full((1,), 0.25, device=device),
            torch.zeros(C, dtype=torch.int32, device=device),
            n_steps=STEPS, seed=11, temps=temps,
            # alpha = (1 - F) / F / u_haps over the 4 haplotypes
            alpha=None if F is None else torch.full((1,), (1 - F) / F / 4, device=device),
        )
        g = K.unpack_genotype_trace(trace.cpu().numpy()[BURN:], P, A)
        codes = np.sort(g[:, :, 0, :] * 2 + g[:, :, 1, :], axis=1)
        idx = genotype_alleles_as_index(codes.transpose(0, 2, 1).reshape(-1, P))
        got = np.bincount(idx, minlength=len(want)).astype(float)
        got /= got.sum()
        tv = 0.5 * np.abs(got - want).sum()
        apart = 0.5 * np.abs(flat - want).sum()
        print(f"phase O ({label}): TV(kernel, exact) = {tv:.4f} (bound 0.03);"
              f" TV(exact flat, exact target) = {apart:.4f}", flush=True)
        if not tv < 0.03:
            _fail(f"phase O ({label})")
        worst = max(worst, tv)
    return worst


def phase_q(device, card):
    """K1 and plain throughput at phase D's shape with 4 rungs and the
    prior."""
    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, A, R, S, C, STEPS = 4, 16, 2, 64, 64, 16384, 200
    temps = Q_TEMPS
    args, kw = k1_shape("Q", device)
    k_ms = time_k1(args, kw, STEPS) * STEPS
    plain_steps = 5
    K.denovo_sampler_plain(*args, n_steps=1, **kw)
    p_ms = _time_cuda(
        lambda: K.denovo_sampler_plain(*args, n_steps=plain_steps, seed=3, **kw), 1
    )
    work = _denovo_work(P, NB, A, R, S, C, STEPS, 1, rungs=len(temps), prior=True)
    bound_ms, bound_by = _bound(work, card)
    print(
        f"phase Q: {C} chains x {len(temps)} rungs P{P} NB{NB} A{A} R{R}, prior:"
        f" kernel {k_ms:.1f} ms for {STEPS} steps = {k_ms / STEPS:.3f} ms per step ="
        f" {C * STEPS / (k_ms / 1e3):.4g} chain-steps/s; plain {p_ms:.1f} ms for"
        f" {plain_steps} steps = {C * plain_steps / (p_ms / 1e3):.4g} chain-steps/s;"
        f" bound {bound_ms:.3f} ms by {bound_by} ({work['flops']:.3g} flops,"
        f" {work['transcendentals']:.3g} exp/log, {work['bytes']:.3g} bytes),"
        f" kernel at {bound_ms / k_ms:.2%} of it",
        flush=True,
    )
    return dict(modes_ms=k_ms / STEPS, modes_plain_ms=p_ms / plain_steps,
                modes_bound_ms=bound_ms / STEPS, modes_bound_by=bound_by)


def phase_r(device):
    """``fit_calling_batch`` routes before any launch: at ploidy 4 to K2,
    at ploidy 9 (outside K2) to the torch sampler, K2's count unmoved."""
    import numpy as np

    from mchap_tpu_torch.models.calling import fit_calling_batch
    from mchap_tpu_torch.testing import simulate_reads
    from mchap_tpu_torch.utils import fallback

    rng = np.random.default_rng(9)
    panel = rng.integers(0, 2, size=(6, 5)).astype(np.int8)
    out = {}
    for ploidy in (4, 9):
        reads = [simulate_reads(panel[rng.integers(0, 6, ploidy)], n_alleles=2,
                                n_reads=40, seed=i) for i in range(3)]
        fallback.PATHS.clear()
        _reset_launches()
        traces = fit_calling_batch(
            ploidy, panel, reads, [np.ones(len(r)) for r in reads], steps=60,
            chains=2, random_seed=1, device=device,
        )
        k2 = _launches()["calling_sampler"]
        paths = sorted(path for (site, path) in fallback.PATHS if site == "calling")
        shapes = sorted({t.genotypes.shape for t in traces})
        finite = all(np.isfinite(t.llks).all() for t in traces)
        print(f"phase R (ploidy {ploidy}): K2 launches {k2}, calling routes {paths},"
              f" trace shapes {shapes}, llks finite {finite}", flush=True)
        out[ploidy] = (k2, paths, shapes, finite)
    if (out[4][:2] != (1, ["cuda"]) or out[9][:3] != (0, ["torch"], [(2, 60, 9)])
            or not (out[4][3] and out[9][3])):
        _fail("phase R")
    return out


def _pinned_noise(args, steps, seed, temps=None):
    """Uniform draws for every step of K1's chains on ``args``."""
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, C = args[2].shape
    D = K.draw_layout(P, NB, 1 if temps is None else len(temps))["D"]
    gen = torch.Generator(device=args[0].device)
    gen.manual_seed(seed)
    return torch.rand((steps, D, C), generator=gen, device=args[0].device)


def _kernel_vs_plain(args, steps, seed, temps=None, alpha=None):
    """K1 and its plain version on the same pinned noise: (fraction of
    identical chains, max llk difference on them, the kernel's trace and
    llks)."""
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K

    noise = _pinned_noise(args, steps, seed, temps)
    kw = dict(n_steps=steps, noise=noise, temps=temps, alpha=alpha)
    t_k, l_k = K.denovo_sampler(*args, **kw)
    with torch.inference_mode():  # less dispatch work per plain-version op
        t_p, l_p = K.denovo_sampler_plain(*args, **kw)
    torch.cuda.synchronize()
    same = (t_k == t_p).all(dim=0).all(dim=0)  # [C]
    err = (l_k - l_p).abs()[:, same].max().item() if same.any() else float("inf")
    return same.float().mean().item(), err, t_k, l_k


def phase_s(device, card, STEPS=200, CHECK=30):
    """K1 at the latency shape of phase C's launches (``LATENCY``): kernel
    vs plain on its first ``CHECK`` steps, pinned noise (bounds as phase
    A), then both timed."""
    from mchap_tpu_torch.ops import cuda_denovo as K

    args, _ = k1_shape("latency", device)
    S, NB, A, R = args[0].shape
    P, _, C = args[2].shape
    frac, err, _, _ = _kernel_vs_plain(args, CHECK, seed=17)
    k_ms = time_k1(args, {}, STEPS)
    plain_steps = 3
    with __import__("torch").inference_mode():
        K.denovo_sampler_plain(*args, n_steps=1)
        p_ms = _time_cuda(lambda: K.denovo_sampler_plain(*args, n_steps=plain_steps, seed=3),
                          1) / plain_steps
    # the sites' options that this run's data has: nall - 1 per position
    options = (args[3].clamp(min=1) - 1).sum(dim=1).double()[args[5].long()].mean().item()
    work = _denovo_work(P, NB, A, R, S, C, STEPS, 1, site_options=options)
    bound_ms, bound_by = _bound(work, card)
    print(
        f"phase S: {C} chains ({S} problems x {C // S}) P{P} NB{NB} A{A} R{R}: identical"
        f" chains {frac:.4f} over {CHECK} steps, llk |kernel-plain| on them {err:.3g}"
        f" (bounds 0.99, 1e-3); kernel {k_ms:.4f} ms per step ="
        f" {C / (k_ms / 1e3):.4g} chain-steps/s; plain {p_ms:.2f} ms per step; bound"
        f" {bound_ms / STEPS:.5f} ms per step by {bound_by}, kernel at"
        f" {bound_ms / STEPS / k_ms:.2%} of it",
        flush=True,
    )
    if frac < 0.99 or err > 1e-3:
        _fail("phase S")
    return dict(latency_ms=k_ms, latency_plain_ms=p_ms, latency_bound_ms=bound_ms / STEPS,
                latency_max_abs_err=err)


def _exact_tv(trace, want, P, burn):
    """TV between a P-ploid 2-SNV biallelic trace's genotype frequencies
    after ``burn`` steps and the exact posterior ``want``."""
    import numpy as np

    from mchap_tpu_torch.numerics.combinadics import genotype_alleles_as_index
    from mchap_tpu_torch.ops import cuda_denovo as K

    g = K.unpack_genotype_trace(trace.cpu().numpy()[burn:], P, 2)  # [T, P, NB, C]
    codes = np.sort(g[:, :, 0, :] * 2 + g[:, :, 1, :], axis=1)
    idx = genotype_alleles_as_index(codes.transpose(0, 2, 1).reshape(-1, P))
    got = np.bincount(idx, minlength=len(want)).astype(float)
    got /= got.sum()
    return 0.5 * np.abs(got - want).sum()


def phase_t(device):
    """Ploidy 10 and 12 on K1: kernel vs plain (bounds as phase A); at
    ploidy 10 K1's Philox stream vs exact enumeration (phase B's bound);
    ``mchap assemble --ploidy 10`` end to end on a small synthetic
    dataset, counting K1 launches."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K
    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops.likelihood import prepare_reads
    from mchap_tpu_torch.testing import simulate_reads
    from mchap_tpu_torch.utils import fallback

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_fixtures import parse_vcf_records, write_dataset

    worst = 0.0
    for P in (10, 12):
        rng = np.random.default_rng(300 + P)
        args = _inputs(rng, 16, P, 8, 2, 64, 1024, device)
        frac, err, t_k, l_k = _kernel_vs_plain(args, 100, seed=P)
        rec = _recompute_llks(t_k, args[0], args[5], P, 2)
        rec_err = (rec - l_k.double()).abs().max().item()
        print(f"phase T (P{P}): identical chains {frac:.4f} of 1024 over 100 steps; llk"
              f" |kernel-plain| on them {err:.3g} (bounds 0.99, 1e-3); llk vs recompute"
              f" {rec_err:.3g} (bound 1e-2)", flush=True)
        if frac < 0.99 or err > 1e-3 or rec_err > 1e-2:
            _fail(f"phase T (P{P})")
        worst = max(worst, err)

    # P10 over 2 biallelic SNVs: 286 genotypes of the 4 haplotypes
    P, C, STEPS, BURN = 10, 1024, 1500, 300
    haplotypes = np.array([[0, 0], [0, 1], [1, 1], [0, 0]] * 3, np.int8)[:P]
    reads = simulate_reads(haplotypes, n_alleles=2, n_reads=20, errors=False,
                           uniform_sample=True, qual=(20, 20), seed=11)
    panel = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)
    want = exact.genotype_posteriors(exact.genotype_likelihoods(reads, P, panel)).numpy()
    lr = prepare_reads(reads, dtype=torch.float32).permute(1, 2, 0)[None].contiguous()
    rng = np.random.default_rng(0)
    trace, _ = K.denovo_sampler(
        lr.to(device), torch.ones((1, len(reads)), device=device),
        torch.from_numpy(rng.integers(0, 2, size=(P, 2, C)).astype(np.int32)).to(device),
        torch.full((1, 2), 2, dtype=torch.int32, device=device),
        torch.full((1,), 0.25, device=device),
        torch.zeros(C, dtype=torch.int32, device=device), n_steps=STEPS, seed=11,
    )
    tv = _exact_tv(trace, want, P, BURN)
    print(f"phase T (P10 exact): TV(kernel, exact) = {tv:.4f} (bound 0.03)", flush=True)
    if not tv < 0.03:
        _fail("phase T (P10 exact)")

    data = write_dataset(
        WORK / "ploidy10", n_samples=4, n_loci=3, snvs_per_locus=8, ploidy=10,
        reads_per_sample=120, n_triallelic=1, error_rate=0.0024, n_founders=4, seed=10,
    )
    argv = ["mchap", "assemble", "--bam", *data["bams"], "--ploidy", "10",
            "--targets", data["targets"], "--variants", data["variants"],
            "--reference", data["reference"]]
    rc, vcf, wall, launches, _ = _run_cli(argv)
    records = parse_vcf_records(vcf)
    agree, total = _truth_agreement(records, data["truth"])
    routes = sorted(path for (site, path) in fallback.PATHS if site == "denovo")
    print(f"phase T (assemble --ploidy 10): exit {rc}, {len(records)} records, K1 launches"
          f" {launches['denovo_sampler']}, de novo routes {routes}, GT == truth"
          f" {agree}/{total}; wall {wall:.2f} s", flush=True)
    if (rc != 0 or len(records) != 3 or launches["denovo_sampler"] < 1 or routes != ["cuda"]
            or total != 12):
        _fail("phase T (assemble --ploidy 10)")
    return worst


def phase_u(device):
    """Read buckets beyond the earlier shared-memory cap, state in device
    scratch: P4 over 16,384 reads and P8 over 4,096 reads, each with a
    ladder and the prior, kernel vs plain on pinned noise (bounds as
    phase A)."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K

    worst = 0.0
    for P, R, temps in ((4, 16384, [0.5, 1.0]), (8, 4096, [0.4, 0.7, 1.0])):
        rng = np.random.default_rng(400 + P)
        S, NB, C, STEPS = 4, 16, 64, 8
        lay = K.chain_state_layout(P, R, NB, len(temps))
        args = _inputs(rng, S, P, NB, 2, R, C, device)
        alpha = torch.full((S,), 0.05, device=device)
        frac, err, _, _ = _kernel_vs_plain(args, STEPS, seed=P, temps=temps, alpha=alpha)
        print(f"phase U (P{P} R{R} T{len(temps)}): state in"
              f" {'shared memory' if lay['in_smem'] else 'scratch'}, {lay['scratch']} bytes"
              f" per chain; identical chains {frac:.4f} of {C} over {STEPS} steps; llk"
              f" |kernel-plain| on them {err:.3g} (bounds 0.99, 1e-3)", flush=True)
        if lay["in_smem"] or frac < 0.99 or err > 1e-3:
            _fail(f"phase U (P{P})")
        worst = max(worst, err)
    return worst


W_LADDER = [round(0.1 * i, 1) for i in range(2, 10)] + [1.0]  # 9 rungs: above K1's 8
# phase W's end-to-end run cuts the default 2 chains x 2000 steps (burn
# 1000).  A step of the torch sampler costs about the same for any number of
# chains (its launches set it), so W runs more, shorter chains: on C's 20
# loci GT == truth read 0.9318 at 6 x 200 steps (burn 100) against 0.9295 at
# 2 x 600 (burn 300), 0.9227 at 8 x 160 and 0.8977 at 4 x 240, and the run
# took 62 s against 100 s (``python -m mchap_tpu_torch.bench_w``; NVIDIA
# H100 80GB HBM3, 700 W)
W_STEPS = ["--mcmc-chains", "6", "--mcmc-steps", "200", "--mcmc-burn", "100"]


@contextlib.contextmanager
def _denovo_sampler_calls():
    """Record the arguments of every call of the torch de novo sampler
    made by ``models/assemble.py``."""
    from mchap_tpu_torch.ops import assemble_mcmc as M

    seen, real = [], M.denovo_sampler

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    M.denovo_sampler = spy
    try:
        yield seen
    finally:
        M.denovo_sampler = real


def _time_torch_sampler(args, kw, cuda_graph, steps):
    """ms per step of the torch de novo sampler on ``args``, eager or
    through its CUDA graph: the difference of two runs of ``steps``
    steps, so that set-up and capture drop out; and the longer run's
    cold trace."""
    import torch

    from mchap_tpu_torch.ops import assemble_mcmc as M

    times, out = [], None
    for n in steps:
        gen = torch.Generator(device=args[1].device)
        gen.manual_seed(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = M.denovo_sampler(gen, *args[1:], **dict(kw, n_steps=n, burn=0,
                                                       cuda_graph=cuda_graph))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * (times[1] - times[0]) / (steps[1] - steps[0]), out


def _w_problems(rng, ploidy, n_problems=3, n_pos=5):
    import numpy as np

    from mchap_tpu_torch.testing import simulate_reads

    panel = rng.integers(0, 2, size=(6, n_pos)).astype(np.int8)
    out = []
    for i in range(n_problems):
        reads = simulate_reads(panel[rng.integers(0, 6, ploidy)], n_alleles=2,
                               n_reads=40, seed=i)
        out.append(dict(reads=reads, counts=np.ones(len(reads)), n_alleles=[2] * n_pos))
    return out


def phase_w_routes(device):
    """``fit_denovo_multi`` chooses its route before any launch: ploidy 4
    to K1; ploidy 14, 9 rungs and a prior with one sample at F = 0 to the
    torch de novo sampler, K1's count unmoved."""
    import numpy as np

    from mchap_tpu_torch.models.assemble import fit_denovo_multi
    from mchap_tpu_torch.utils import fallback

    rng = np.random.default_rng(14)
    cases = (
        ("ploidy 4", 4, {}, None),
        ("ploidy 14", 14, {}, None),
        ("9 rungs", 4, dict(temperatures=W_LADDER), None),
        ("prior F = 0 and 0.1", 4, {}, [0.0, 0.1, 0.1]),
    )
    ok = True
    for label, ploidy, kw, inbreeding in cases:
        problems = _w_problems(rng, ploidy)
        if inbreeding is not None:
            problems = [dict(p, inbreeding=f) for p, f in zip(problems, inbreeding)]
        fallback.PATHS.clear()
        _reset_launches()
        traces = fit_denovo_multi(problems, ploidy, steps=60, chains=2, burn=20,
                                  random_seed=1, device=device, **kw)
        k1 = _launches()["denovo_sampler"]
        paths = sorted(path for (site, path) in fallback.PATHS if site == "denovo")
        # K1's route tabulates its trace: (chains, kept steps, P, NB) either way
        shapes = sorted({
            t.genotypes.shape if hasattr(t, "genotypes")
            else (t.states.shape[0], t.kept) + t.states.shape[2:] for t in traces
        })
        finite = all(np.isfinite(t.llks).all() for t in traces)
        print(f"phase W (route, {label}): K1 launches {k1}, de novo routes {paths},"
              f" trace shapes {shapes}, llks finite {finite}", flush=True)
        want = (1, ["cuda"]) if label == "ploidy 4" else (0, ["torch"])
        ok &= (k1, paths) == want and shapes == [(2, 40, ploidy, 5)] and finite
    if not ok:
        _fail("phase W (routes)")


def phase_w_block(device, ploidy=16, n_reads=1024, n_problems=440, steps=3):
    """The torch de novo sampler on a block of phase C's size (440
    problems x 2 chains) at ploidy 16 and 1024 reads per problem, where
    one interval step over the whole block would need about 110 GB of
    [B, K, R, P] temporaries: ``rows_per_chunk`` splits it into pieces
    that fit a quarter of the free memory.  Gate: the torch route, the
    block split, the peak below the card's memory, finite llks."""
    import numpy as np
    import torch

    from mchap_tpu_torch.models.assemble import fit_denovo_multi
    from mchap_tpu_torch.ops import assemble_mcmc as M
    from mchap_tpu_torch.testing import simulate_reads
    from mchap_tpu_torch.utils import fallback

    rng = np.random.default_rng(16)
    n_pos = 5
    distinct = []
    for i in range(22):
        haps = rng.integers(0, 2, size=(ploidy, n_pos)).astype(np.int8)
        haps[:2] = [[0], [1]]  # every position heterozygous
        reads = simulate_reads(haps, n_alleles=2, n_reads=n_reads, seed=i)
        distinct.append(dict(reads=reads, counts=np.ones(len(reads)), n_alleles=[2] * n_pos))
    problems = [distinct[i % 22] for i in range(n_problems)]
    chunks, real = [], M.rows_per_chunk

    def spy(*args):
        chunks.append(real(*args))
        return chunks[-1]

    fallback.PATHS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    M.rows_per_chunk = spy
    t = time.perf_counter()
    try:
        traces = fit_denovo_multi(problems, ploidy, steps=steps, chains=2, burn=1,
                                  random_seed=1, device=device)
    finally:
        M.rows_per_chunk = real
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device)
    total = torch.cuda.get_device_properties(device).total_memory
    rows = 2 * n_problems
    routes = sorted(path for (site, path) in fallback.PATHS if site == "denovo")
    shapes = sorted({t.genotypes.shape for t in traces})
    finite = all(np.isfinite(t.llks).all() for t in traces)
    print(f"phase W (block, P{ploidy} R{n_reads}, {n_problems} problems x 2 chains):"
          f" routes {routes}, rows per piece {chunks} of {rows}, peak"
          f" {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB, trace shapes {shapes},"
          f" llks finite {finite}, {wall:.2f} s for {steps} steps", flush=True)
    if (routes != ["torch"] or len(chunks) != 1 or not chunks[0] < rows
            or peak >= total or shapes != [(2, steps - 1, ploidy, n_pos)] or not finite):
        _fail("phase W (block)")


def phase_w_exact(device, chains=512, steps=180, burn=60):
    """The torch de novo sampler on the card against exact enumeration
    over the full haplotype space, on the CPU tests' cases
    (tests/test_torch_assemble_mcmc.py): ploidy 14 over 2 biallelic SNVs,
    9 rungs, F = 0 and F = 0.2 in one block, two intervals.  CUDA's
    Philox stream is not the CPU's, so this is the sampler's check on
    the card.  Bound: 0.05 per genotype.  512 chains x 120 kept steps
    (was 256 x 240): as many samples, in fewer steps, since a step costs
    about the same for any chain count."""
    import numpy as np
    import torch

    from mchap_tpu_torch.models.assemble import fit_denovo_multi
    from mchap_tpu_torch.numerics.combinadics import (
        enumerate_genotypes,
        genotype_alleles_as_index,
    )
    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops.priors import log_genotype_prior
    from mchap_tpu_torch.testing import simulate_reads
    from mchap_tpu_torch.utils import fallback

    panel = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.int8)
    truth = np.array([[0, 0], [0, 0], [0, 1], [1, 1]], np.int8)
    worst = 0.0
    for label, ploidy, kw, inbreeding in (
        ("P14", 14, dict(fix_homozygous=1.1), (None,)),
        ("9 rungs", 4, dict(temperatures=W_LADDER), (None,)),
        ("F = 0 and 0.2", 4, {}, (0.0, 0.2)),
        ("n_intervals=2", 4, dict(n_intervals=2), (None,)),
    ):
        haps = truth if ploidy == 4 else np.concatenate([truth] * 3 + [panel[1:3]])
        reads = simulate_reads(haps, n_alleles=2, n_reads=8 if ploidy == 4 else 6,
                               qual=(15, 25), seed=3)
        problems = [dict(reads=reads, counts=np.ones(len(reads)), n_alleles=[2, 2])
                    for _ in inbreeding]
        if inbreeding[0] is not None:
            problems = [dict(p, inbreeding=f) for p, f in zip(problems, inbreeding)]
        fallback.PATHS.clear()
        if "n_intervals" in kw:
            from mchap_tpu_torch.models.assemble import DenovoMCMC

            traces = [DenovoMCMC(ploidy=ploidy, n_alleles=[2, 2], steps=steps,
                                 chains=chains, random_seed=7, device=device,
                                 **kw).fit(reads).burn(burn)]
        else:
            traces = fit_denovo_multi(problems, ploidy, steps=steps, chains=chains,
                                      burn=burn, random_seed=7, device=device, **kw)
        routes = sorted(path for (site, path) in fallback.PATHS if site == "denovo")
        llks = exact.genotype_likelihoods(reads, ploidy, panel)
        errs = []
        for f, trace in zip(inbreeding, traces):
            want = llks
            if f is not None:
                table = torch.tensor(enumerate_genotypes(4, ploidy))
                want = llks + log_genotype_prior(table, 4, inbreeding=f)
            want = exact.genotype_posteriors(want).numpy()
            g = trace.genotypes
            codes = np.sort(g[..., 0] * 2 + g[..., 1], axis=-1).reshape(-1, ploidy)
            got = np.bincount(genotype_alleles_as_index(codes), minlength=len(want))
            errs.append(np.abs(got / got.sum() - want).max())
        print(f"phase W (exact, {label}): routes {routes}, max |sampled - exact| per"
              f" genotype {max(errs):.4f} (bound 0.05) over {chains} chains x"
              f" {steps - burn} kept steps", flush=True)
        if routes != ["torch"] or not max(errs) < 0.05:
            _fail(f"phase W (exact, {label})")
        worst = max(worst, max(errs))
    return worst


def phase_w_assemble(device, data):
    """``mchap assemble --use-dirmul-prior FILE`` end to end on phase C's
    reads, the first sample at F = 0 and the others at 0.1 (breeders
    write such a file when one parent is outbred): every block takes the
    torch de novo sampler, in two calls: the 15 biallelic loci's block and
    the 5 triallelic loci's (A = 3).  Then the sampler's ms per step at the
    larger call's shape, eager and through its CUDA graph, with the same
    draws."""
    import torch

    from test_torch_fixtures import parse_vcf_records

    from mchap_tpu_torch.utils import fallback

    n_loci = 20
    path = WORK / "assemble" / "inbreeding.txt"
    path.write_text("".join(f"{s}\t{0.1 if i else 0.0}\n"
                            for i, s in enumerate(data["samples"])))
    argv = [
        "mchap", "assemble", "--bam", *data["bams"], "--ploidy", "4",
        "--targets", data["targets"], "--variants", data["variants"],
        "--reference", data["reference"], "--use-dirmul-prior", str(path), *W_STEPS,
    ]
    with _denovo_sampler_calls() as calls:
        rc, vcf, wall, launches, timers = _run_cli(argv)
    (WORK / "assemble" / "out_mixed_f.vcf").write_text(vcf)
    records = parse_vcf_records(vcf)
    agree, total = _truth_agreement(records, data["truth"])
    frac = agree / max(total, 1)
    k1 = launches["denovo_sampler"]
    routes = sorted(path for (site, path) in fallback.PATHS if site == "denovo")
    steps = int(W_STEPS[W_STEPS.index("--mcmc-steps") + 1])
    alleles = sorted(args[2].shape[-1] for args, _ in calls)
    sampler_s = timers.stages.get("device.torch_sampler", float("nan"))
    print(
        f"phase W: assemble --use-dirmul-prior (F = 0 for {data['samples'][0]}, 0.1"
        f" for the rest) {' '.join(W_STEPS)} exit {rc}, {len(records)} records, K1"
        f" launches {k1}, de novo routes {routes}, sampler calls {len(calls)} at A ="
        f" {alleles}, GT =="
        f" truth {agree}/{total} = {frac:.4f} (bound 0.90); wall {wall:.2f} s ="
        f" {n_loci / wall:.3f} loci/s; torch sampler {sampler_s:.2f} s ="
        f" {1e3 * sampler_s / steps:.2f} ms per step over its {len(calls)} calls",
        flush=True,
    )
    for line in timers.summary_lines():
        print("phase W timing:", line, flush=True)
    if (rc != 0 or len(records) != n_loci or k1 != 0 or routes != ["torch"]
            or alleles != [2, 3] or total != 440 or frac < 0.90):
        _fail("phase W (assemble)")

    args, kw = max(calls, key=lambda c: c[0][1].numel())
    S, C, P, NB = args[1].shape
    shape = dict(S=S, chains=C, P=P, NB=NB, R=args[2].shape[1], A=args[2].shape[-1],
                 rungs=len(args[6]), prior=kw.get("inbreeding") is not None)
    # eager steps take about 0.45 s each, graphed ones about 0.08 s; a
    # step's draws do not depend on the run's length, so the eager trace
    # must equal the graphed one's first steps
    eager_ms, eager = _time_torch_sampler(args, kw, cuda_graph=False, steps=(2, 6))
    graph_ms, graph = _time_torch_sampler(args, kw, cuda_graph=True, steps=(3, 23))
    same = all(torch.equal(a, b[:, :, :a.shape[2]]) for a, b in zip(eager, graph))
    print(f"phase W sampler at the largest call's shape {json.dumps(shape)}: eager"
          f" {eager_ms:.2f} ms per step, CUDA graph {graph_ms:.2f} ms per step;"
          f" traces identical {same}", flush=True)
    if not same:
        _fail("phase W (graph vs eager)")
    return dict(eager_ms=eager_ms, graph_ms=graph_ms, shape=shape,
                sampler_ms_per_step=1e3 * sampler_s / steps)


def phase_x(device, data):
    """``mchap call-exact`` end to end on phase C's reads with phase C's
    output VCF as the panel (as phase G): the block path; then with
    ``--report GP``, which sends every locus down the per-locus path and
    must give the same GTs."""
    from test_torch_fixtures import parse_vcf_records

    from mchap_tpu_torch.utils import fallback

    n_loci = 20
    g_calls = {rec["ID"]: {s: c["GT"] for s, c in rec["calls"].items()}
               for rec in parse_vcf_records((WORK / "assemble" / "call.vcf").read_text())}
    argv = [
        "mchap", "call-exact", "--bam", *data["bams"], "--ploidy", "4",
        "--haplotypes", str(data["assembled"]), "--reference", data["reference"],
    ]
    gts = {}
    for label, extra in (("block", []), ("per-locus, --report GP", ["--report", "GP"])):
        rc, vcf, wall, _, timers = _run_cli(argv + extra)
        routes = sorted(path for (site, path) in fallback.PATHS if site == "call-exact")
        records = parse_vcf_records(vcf)
        agree, total = _truth_agreement(records, data["truth"])
        frac = agree / max(total, 1)
        incomplete = sum("." in c["GT"] for rec in records if rec["FILTER"] == "PASS"
                         for c in rec["calls"].values())
        gts[label] = {rec["ID"]: {s: c["GT"] for s, c in rec["calls"].items()}
                      for rec in records}
        same_g = sum(gts[label][r][s] == g_calls.get(r, {}).get(s)
                     for r in gts[label] for s in gts[label][r])
        print(f"phase X ({label}): call-exact exit {rc}, {len(records)} records, routes"
              f" {routes}, GT with '.' in PASS records {incomplete}, GT == truth"
              f" {agree}/{total} = {frac:.4f} (bound 0.90), GT == phase G's"
              f" {same_g}/{total}; wall {wall:.2f} s = {n_loci / wall:.3f} loci/s",
              flush=True)
        for line in timers.summary_lines():
            print(f"phase X ({label}) timing:", line, flush=True)
        want_route = ["block"] if label == "block" else ["per-locus"]
        if (rc != 0 or len(records) != n_loci or incomplete or total != 440
                or frac < 0.90 or routes != want_route):
            _fail(f"phase X ({label})")
    same = gts["block"] == gts["per-locus, --report GP"]
    print(f"phase X: GT of the per-locus path == the block path's: {same}", flush=True)
    if not same:
        _fail("phase X (per-locus vs block)")


def phase_y(device, data):
    """``mchap find-snvs`` on phase C's reads, reference and targets, and
    ``mchap atomize``, where no JAX is installed.  find-snvs: every record
    inside a target, at least 95% of them at one of the 866 true SNV
    positions.  atomize reads ``call-exact``'s output over C's founder
    panel, whose SNVPOS lists the positions where the panel varies:
    atomize (a copy of mchap_tpu's) raises IndexError on a record with an
    SNVPOS position where no haplotype varies, which C's assemble output
    has (ROADMAP, reference faults).  Gate: every record one base at a
    true SNV position."""
    from test_torch_fixtures import parse_vcf_records, write_haplotype_vcf

    import warnings

    truth = set()
    for line in open(data["variants"]):
        if not line.startswith("#"):
            chrom, pos = line.split("\t")[:2]
            truth.add((chrom, int(pos)))
    targets = [line.split("\t")[:3] for line in open(data["targets"]) if line.strip()]

    def inside(chrom, pos):
        return any(c == chrom and int(a) < pos <= int(b) for c, a, b in targets)

    argv = ["mchap", "find-snvs", "--bam", *data["bams"], "--reference",
            data["reference"], "--targets", data["targets"]]
    rc, vcf, wall, _, _ = _run_cli(argv)
    sites = [(r["CHROM"], int(r["POS"])) for r in parse_vcf_records(vcf)]
    outside = sum(not inside(*s) for s in sites)
    precision = sum(s in truth for s in sites) / max(len(sites), 1)
    recall = len(truth & set(sites)) / len(truth)
    print(f"phase Y: find-snvs exit {rc}, {len(sites)} records, outside a target"
          f" {outside}, at a true SNV {precision:.4f} (bound 0.95), recall of the"
          f" {len(truth)} true SNVs {recall:.4f}; wall {wall:.2f} s", flush=True)
    if rc != 0 or not sites or outside or precision < 0.95:
        _fail("phase Y (find-snvs)")

    panel = write_haplotype_vcf(WORK / "assemble" / "founders.vcf", data)
    rc, vcf, _, _, _ = _run_cli(["mchap", "call-exact", "--bam", *data["bams"], "--ploidy",
                                 "4", "--haplotypes", panel, "--reference",
                                 data["reference"], "--device", device.type])
    called = WORK / "assemble" / "founders_called.vcf"
    called.write_text(vcf)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the tool is experimental
        rc_a, vcf, wall, _, _ = _run_cli(["mchap", "atomize", str(called)])
    records = parse_vcf_records(vcf)
    bad = sum(len(r["REF"]) != 1 or (r["CHROM"], int(r["POS"])) not in truth
              for r in records)
    print(f"phase Y: atomize of call-exact's output over C's founders exit {rc_a}"
          f" (call-exact {rc}), {len(records)} records, not one base at a true SNV"
          f" {bad}; wall {wall:.2f} s", flush=True)
    if rc != 0 or rc_a != 0 or not records or bad:
        _fail("phase Y (atomize)")


# phase Z: the problems of a block over a list of devices; one card named
# three times splits each block three ways (440 problems: 147 + 147 + 146)
Z_SHARDS = 3

# one rank of phase Z's two-process `mchap call`: records each K2 launch's
# shape and chain offset, runs the CLI on argv[2:], and writes its wall and
# shapes to argv[1] + "<rank>.json" (the VCF goes to standard output)
_Z_RANK = r"""
import json, sys, time
t0 = time.perf_counter()
from mchap_tpu_torch.ops import cuda_calling as KC
shapes, real = [], KC._launch
def spy(rh, counts, n_valid, problem, **kw):
    shapes.append(dict(device=str(rh.device), S=rh.shape[0], R=rh.shape[1], H=rh.shape[2],
                       chains=problem.numel(), chain_offset=kw["chain_offset"]))
    return real(rh, counts, n_valid, problem, **kw)
KC._launch = spy
from mchap_tpu_torch.application.cli import main
from mchap_tpu_torch.parallel.distributed import world
rc = main(["mchap", *sys.argv[2:]])
rank = world()[0]
json.dump(dict(rc=rc, wall=time.perf_counter() - t0, rank=rank, shapes=shapes,
               launches=KC.calling_sampler.launches), open(f"{sys.argv[1]}{rank}.json", "w"))
"""


@contextlib.contextmanager
def _sharded_launches(module, name):
    """Record (device, problems, chain offset) of every call of kernel
    wrapper ``name`` made through ``module``."""
    seen, real = [], getattr(module, name)

    def spy(*args, **kw):
        seen.append((str(args[0].device), int(args[0].shape[0]), kw.get("chain_offset", 0)))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _same_traces(a, b):
    """Largest |llk| difference of two runs' traces, or inf where their
    genotypes (tabulated: distinct states and counts) differ."""
    import numpy as np

    err = 0.0
    for x, y in zip(a, b, strict=True):
        if hasattr(x, "states"):
            for c in range(len(x.counts)):
                mx, my = x.counts[c] > 0, y.counts[c] > 0
                if not (np.array_equal(x.states[c][mx], y.states[c][my])
                        and np.array_equal(x.counts[c][mx], y.counts[c][my])):
                    return float("inf")
                err = max(err, float(np.abs(x.llks[c][mx] - y.llks[c][my]).max(initial=0)))
        else:
            if not np.array_equal(x.genotypes, y.genotypes):
                return float("inf")
            err = max(err, float(np.abs(np.nan_to_num(x.llks) - np.nan_to_num(y.llks))
                                 .max(initial=0)))
    return err


def _z_compare(label, run, module, attr, name, device):
    """``run(devices)`` on one card unsharded and split Z_SHARDS ways, each
    with the launch counts at 0 just before; returns the largest llk
    difference and prints kernel ``name``'s launches per device, recorded
    by a spy on ``module.attr`` (a name the model calls it by, or the
    wrapper's own ``_launch``: the wrapper counts through its module's
    global name, which a spy must not replace)."""
    out, launches = {}, {}
    for n in (1, Z_SHARDS):
        _reset_launches()
        with _sharded_launches(module, attr) as seen:
            t = time.perf_counter()
            out[n] = run([device] * n)
            wall = time.perf_counter() - t
        launches[n] = _launches()[name]
        print(f"phase Z ({label}, {n} shard{'s' * (n > 1)}): launches {launches[n]},"
              f" (device, problems, chain offset) {seen}; {wall:.2f} s", flush=True)
        if launches[n] != n or len(seen) != n:
            _fail(f"phase Z ({label}): {launches[n]} launches for {n} shards")
    err = _same_traces(out[Z_SHARDS], out[1])
    print(f"phase Z ({label}): {Z_SHARDS} shards vs 1, genotypes identical"
          f" {err != float('inf')}, max |llk difference| {err:.3g} (bound 0)", flush=True)
    if err != 0.0:
        _fail(f"phase Z ({label})")
    return err


def phase_z(device, data, S=LATENCY["S"], K1_STEPS=LATENCY["steps"], K2_STEPS=2000,
            LOCI=128, K3_STEPS=500):
    """A block's problems over a list of devices (``parallel/``): one card
    named three times, so each block splits three ways, against the
    unsharded launch -- K1 at phase S's shape (flat, then phase N's T = 3
    with alpha 0.05), tabulation on; K2 at ``LATENCY_K2`` over 2000 steps;
    K3 through the pedigree model at phase M's 128 loci x 1 chain, 500
    steps.  Genotypes and llks must be identical (each kernel keys its
    draws by global chain).  Then ``mchap call`` as phase G in two
    processes on the card (gloo): rank 0's records must be phase G's
    byte for byte, rank 1 writes none.  Then the INFO pools on the card
    against the host formulas."""
    import numpy as np
    import torch

    from mchap_tpu_torch.models import assemble as MA
    from mchap_tpu_torch.models import calling as MC
    from mchap_tpu_torch.models import pedigree as MP
    from mchap_tpu_torch.parallel import launch, pools
    from mchap_tpu_torch.testing import simulate_reads

    cpu = torch.device("cpu")
    errs = {}
    # K1: phase S's inputs in the model's layout
    lr, counts, g0, nall, _, _ = (
        x.numpy() for x in _latency_inputs(np.random.default_rng(26), cpu, S=S))
    S, NB, A, R = lr.shape
    P, chains = LATENCY["P"], LATENCY["chains"]
    log_reads = np.ascontiguousarray(lr.transpose(0, 3, 1, 2))
    init = g0.reshape(P, NB, S, chains).transpose(2, 3, 0, 1)
    break_dist = np.zeros((S, NB))
    break_dist[:, :2] = [0.25, 0.75]
    for label, temps, alphas, key in (
        ("K1 flat", (1.0,), None, "denovo_sampler"),
        ("K1 T=3 alpha 0.05", (0.33, 0.66, 1.0), np.full(S, 0.05),
         "denovo_sampler (ladder and prior)"),
    ):
        errs[key] = _z_compare(label, lambda devices: MA._fit_denovo_batch_kernel(
            log_reads, counts, init, nall, break_dist, P, K1_STEPS, chains, 11,
            0.5, 0.5, 1.0, device, burn=K1_STEPS // 2, tabulate=True, temperatures=temps,
            alphas=alphas, devices=devices), MA, "denovo_sampler", "denovo_sampler", device)

    # K2 at phase G's launch shape
    shape = LATENCY_K2
    rh, counts2, n_valid, _ = (x.numpy() for x in _calling_inputs(
        np.random.default_rng(27), S, shape["P"], shape["H"], shape["R"],
        S * shape["chains"], cpu, n_valid=[6], adjacent=True))
    errs["calling_sampler"] = _z_compare("K2", lambda devices: MC._fit_batch_kernel(
        rh, counts2, shape["P"], K2_STEPS, shape["chains"], 13, n_valid, K2_STEPS // 2,
        device=device, devices=devices), MC, "calling_sampler", "calling_sampler", device)

    # K3 through the pedigree model at phase M's shape
    rng = np.random.default_rng(28)
    parents = np.asarray(BIPARENTAL)
    n_samples = len(parents)
    problems = []
    for _ in range(LOCI):
        panel = rng.integers(0, 2, size=(16, 16))
        geno, reads = [], []
        for i, (a, b) in enumerate(parents):
            geno.append(rng.integers(0, 16, 4) if a < 0 else np.concatenate(
                [rng.choice(geno[a], 2, replace=False), rng.choice(geno[b], 2, replace=False)]))
            reads.append(simulate_reads(panel[geno[i]], n_alleles=2, n_reads=64, errors=True,
                                        error_rate=0.0024, seed=int(rng.integers(1 << 30))))
        problems.append(dict(sample_reads=np.stack(reads),
                             sample_read_counts=np.ones((n_samples, 64), int),
                             haplotypes=panel.astype(np.int8)))
    design = (np.full(n_samples, 4), parents, np.full((n_samples, 2), 2),
              np.zeros((n_samples, 2)), np.full((n_samples, 2), 0.1))

    def k3(devices):  # K3 records no llks: the genotypes are compared
        trace, _ = MP._fit(problems, *design, K3_STEPS, 1, 7, "Gibbs", True, 0, device,
                           devices=devices)
        return [types.SimpleNamespace(genotypes=t, llks=np.zeros(1)) for t in trace]

    errs["pedigree_sampler"] = _z_compare("K3", k3, MP._k3, "_launch", "pedigree_sampler",
                                          device)

    # `mchap call` in two processes on the one card
    argv = ["call", "--bam", *data["bams"], "--ploidy", "4", "--haplotypes",
            str(data["assembled"]), "--reference", data["reference"], "--device", device.type]
    prefix = WORK / "assemble" / "call_rank"
    outs = [f"{prefix}{r}.vcf" for r in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MCHAP_EMIT_ALL_HOSTS", "MCHAP_TIMING")}
    t = time.perf_counter()
    codes = launch.launch(["-c", _Z_RANK, str(prefix), *argv], 2, stdout=outs, timeout=600,
                          env=env)
    wall = time.perf_counter() - t
    info = [] if any(codes) else [json.loads(pathlib.Path(f"{prefix}{r}.json").read_text())
                                  for r in range(2)]

    def records(text):
        return [line for line in text.splitlines()
                if not line.startswith(("##fileDate", "##commandline"))]

    rank0 = records(pathlib.Path(outs[0]).read_text())
    same = rank0 == records((WORK / "assemble" / "call.vcf").read_text())
    rank1 = pathlib.Path(outs[1]).read_text()
    for i in info:
        print(f"phase Z (call, rank {i['rank']} of 2): exit {i['rc']}, wall {i['wall']:.2f} s,"
              f" K2 launches {i['launches']}: {json.dumps(i['shapes'])}", flush=True)
    print(f"phase Z (call, 2 ranks on one card, gloo): exit codes {codes}, {wall:.2f} s;"
          f" rank 0 {sum(not x.startswith('#') for x in rank0)} records, identical to"
          f" phase G's {same}; rank 1 wrote {len(rank1)} bytes", flush=True)
    if any(codes) or not same or rank1 or [i["rank"] for i in info] != [0, 1]:
        _fail("phase Z (two-rank call)")

    # INFO pools on the card
    rng = np.random.default_rng(0)
    n_problems, n_loci, k = 440, 20, 6
    locus_ids = np.repeat(np.arange(n_loci), 22)
    acp, aop = rng.uniform(0, 4, (n_problems, k)), rng.uniform(0, 1, (n_problems, k))
    snvdp = rng.integers(0, 50, (n_problems, k)).astype(float)
    got = [x.cpu().numpy() for x in pools.pooled_info(
        [device] * Z_SHARDS, n_loci, locus_ids, acp, aop, snvdp)]
    sel = locus_ids[None, :] == np.arange(n_loci)[:, None]
    want = [np.stack([f(m) for m in sel]) for f in (
        lambda m: acp[m].sum(0), lambda m: aop[m].sum(0),
        lambda m: 1 - np.prod(1 - aop[m], axis=0), lambda m: snvdp[m].sum(0))]
    pool_err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"phase Z (pools, {n_problems} problems over {Z_SHARDS} shards): max |card -"
          f" host| {pool_err:.3g} (bound 1e-12)", flush=True)
    if not pool_err <= 1e-12:
        _fail("phase Z (pools)")
    return dict(errs=errs, call_wall=wall, call_rank_walls=[i["wall"] for i in info])


def _card():
    """Name and power limit line, SM count and special-function rate."""
    import torch

    line = _card_line()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(line=line, sms=sms, sfu_rate=16 * sms * float(clock) * 1e6,
                clock_mhz=float(clock))


def _build_all():
    """Build the four kernel libraries at once (one nvcc each; K1's
    source twice, flat with K0 and with its ladder), then print each
    build's time and ptxas's register lines."""
    from concurrent.futures import ThreadPoolExecutor

    from mchap_tpu_torch.ops import cuda_calling as KC
    from mchap_tpu_torch.ops import cuda_denovo as K
    from mchap_tpu_torch.ops import cuda_pedigree as K3

    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    builds = (
        ("K1 flat/K0", K.load_library, K.build_log_path()),
        ("K1 ladder", lambda: K.load_library(ladder=True), K.build_log_path(ladder=True)),
        ("K2", KC.load_library, KC.build_log_path()),
        ("K3", K3.load_library, K3.build_log_path()),
    )
    with ThreadPoolExecutor(len(builds)) as pool:
        times = list(pool.map(timed, [load for _, load, _ in builds]))
    for (name, _, log), t in zip(builds, times):
        print(f"build: {name} built and loaded in {t:.1f} s", flush=True)
        for line in log.read_text().splitlines():
            spills = "stack frame" in line and not line.split(":")[-1].strip().startswith("0 bytes")
            if ("Used" in line and "registers" in line) or spills:
                print(f"ptxas ({name}):", line.split("info    :")[-1].strip())


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false; this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))

    device = torch.device("cuda", 0)
    card = _card()
    print(card["line"], flush=True)
    print(
        f"card: {card['sms']} SMs, max SM clock {card['clock_mhz']:.0f} MHz,"
        f" special-function rate {card['sfu_rate']:.4g}/s",
        flush=True,
    )
    t0 = time.perf_counter()
    _build_all()
    print(f"time: build {time.perf_counter() - t0:.1f} s", flush=True)

    results = {}
    runners = [
        ("A", lambda: phase_a(device)),
        ("B", lambda: phase_b(device)),
        ("C", lambda: phase_c(device)),
        ("D", lambda: phase_d(device, card)),
        ("E", lambda: phase_e(device)),
        ("F", lambda: phase_f(device)),
        ("G", lambda: phase_g(device, results["C"][1])),
        ("H", lambda: phase_h(device, card)),
        ("I", lambda: phase_i(device, card)),
        ("J", lambda: phase_j(device)),
        ("K", lambda: phase_k(device)),
        ("L", lambda: phase_l(device)),
        ("M", lambda: phase_m(device, card)),
        ("N", lambda: phase_n(device)),
        ("O", lambda: phase_o(device)),
        ("P", lambda: phase_c(device, TEMPERED_DIRMUL, label="P",
                              out_name="out_options.vcf")),
        ("Q", lambda: phase_q(device, card)),
        ("R", lambda: phase_r(device)),
        ("S", lambda: phase_s(device, card)),
        ("T", lambda: phase_t(device)),
        ("U", lambda: phase_u(device)),
        ("V", lambda: phase_v(device, card)),
        ("W", lambda: (phase_w_routes(device), phase_w_block(device), phase_w_exact(device),
                       phase_w_assemble(device, results["C"][1]))[-1]),
        ("X", lambda: phase_x(device, results["C"][1])),
        ("Y", lambda: phase_y(device, results["C"][1])),
        ("Z", lambda: phase_z(device, results["C"][1])),
    ]
    for name, run in runners:
        t = time.perf_counter()
        results[name] = run()
        print(f"time: phase {name} {time.perf_counter() - t:.1f} s", flush=True)

    torch.cuda.synchronize()
    main_paths = (results["C"][0], results["G"], results["L"])
    err_i, i = results["I"]
    q = results["Q"]
    kernels = [
        # K1's flat single-rung instance, denovo_kernel: phase C's path
        dict(name="denovo_sampler", source="mchap_tpu_torch/csrc/denovo_sampler.cu",
             replaces="mchap_tpu/ops/pallas_denovo.py:270",
             launches=main_paths[0]["denovo_sampler"],
             max_abs_err=max(results["A"], results["T"]), **results["D"], **results["S"]),
        # K1's ladder-and-prior instance, denovo_ladder_kernel (-DK1_LADDER):
        # phase P's path; the same wrapper counts both instances' launches
        dict(name="denovo_sampler (ladder and prior)",
             source="mchap_tpu_torch/csrc/denovo_sampler.cu",
             replaces="mchap_tpu/ops/pallas_denovo.py:270",
             launches=results["P"][0]["denovo_sampler"],
             max_abs_err=max(results["N"], results["U"]), ms=q["modes_ms"],
             plain_ms=q["modes_plain_ms"], bound_ms=q["modes_bound_ms"],
             bound_by=q["modes_bound_by"]),
        dict(name="calling_sampler", source="mchap_tpu_torch/csrc/calling_sampler.cu",
             replaces="mchap_tpu/ops/pallas_calling.py:55",
             launches=main_paths[1]["calling_sampler"],
             max_abs_err=max(results["E"], results["V"]["latency_max_abs_err"]),
             **results["H"], **results["V"]),
        dict(name="mutation_sweep", source="mchap_tpu_torch/csrc/denovo_sampler.cu",
             replaces="mchap_tpu/ops/pallas_denovo.py:76",
             launches=sum(p["mutation_sweep"] for p in main_paths),
             max_abs_err=err_i, **i),
        dict(name="pedigree_sampler", source="mchap_tpu_torch/csrc/pedigree_sampler.cu",
             replaces="mchap_tpu/ops/pallas_pedigree.py:609",
             launches=results["L"]["pedigree_sampler"], max_abs_err=results["J"],
             **results["M"]),
    ]
    z = results["Z"]["errs"]
    for k in kernels:
        if k["name"] in z:  # K0 runs on no sharded path
            k["sharded_max_abs_err"] = z[k["name"]]
            k["shard_counts"] = [1, Z_SHARDS]
    for k in kernels:
        k["route"] = "cuda"
        k["library_ms"] = None  # no single PyTorch call computes a sampler step
    print(f"time: total {time.perf_counter() - t0:.1f} s, build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
