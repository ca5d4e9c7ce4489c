"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (needs CUDA; exits nonzero without it)

Builds the port's CUDA kernel libraries from ``mchap_tpu_torch/csrc``
in parallel -- ``denovo_sampler.cu`` twice (K1, the de novo sampler,
flat with K0, one mutation sweep; and K1 with its tempering ladder and
prior), ``calling_sampler.cu`` (K2, the calling sampler) and
``pedigree_sampler.cu`` (K3, the pedigree Gibbs sampler) -- and runs
eighteen phases, each printing one line:

A. K1 vs its plain PyTorch version on the card, pinned noise;
B. K1 with its own Philox stream vs exact enumeration;
C. ``mchap assemble`` end to end through the port's CLI entry point on
   a synthetic 22-sample x 20-locus tetraploid dataset, counting K1
   launches and checking genotype calls against the truth;
D. K1 and plain throughput at 16,384 chains x 200 steps;
E. K2 vs its plain version, pinned noise;
F. K2 with its own Philox stream vs exact enumeration;
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
   any launch: K2's launch count does not move.

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
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, R, C, STEPS = 4, 16, 64, 1024, 300
    worst = {}
    for A in (2, 3):
        rng = np.random.default_rng(100 + A)
        args = _inputs(rng, 16, P, NB, A, R, C, device)
        D = K.draw_layout(P, NB)["D"]
        gen = torch.Generator(device=device)
        gen.manual_seed(A)
        noise = torch.rand((STEPS, D, C), generator=gen, device=device)
        t_k, l_k = K.denovo_sampler(*args, n_steps=STEPS, noise=noise)
        with torch.inference_mode():  # less dispatch work per plain-version op
            t_p, l_p = K.denovo_sampler_plain(*args, n_steps=STEPS, noise=noise)
        torch.cuda.synchronize()
        same = (t_k == t_p).all(dim=0).all(dim=0)  # [C]
        frac = same.float().mean().item()
        err = (l_k - l_p).abs()[:, same].max().item()
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
    from test_torch_fixtures import parse_vcf_records, write_dataset

    from mchap_tpu_torch.constant import PFEIFFER_ERROR

    n_loci = 20
    snvs = [44] * 6 + [43] * 14  # 866 in all
    data = write_dataset(
        WORK / "assemble", n_samples=22, n_loci=n_loci, snvs_per_locus=snvs,
        ploidy=4, reads_per_sample=64, n_triallelic=5,
        error_rate=PFEIFFER_ERROR, n_founders=6, locus_length=300,
        founder_snvs=6, seed=2024,
    )
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


def _denovo_work(P, NB, A, R, S, C, T, trace_bytes, rungs=1, prior=False):
    """K1 per launch of T steps, counted from denovo_sampler.cu: every
    site's candidate pass of the mutation sweep (per read and option: 10
    f32 operations, expf and log1pf; a 5-step butterfly per option), the
    other rows' logsumexp per row, and the interval sums of stage 2; with
    the prior, per option two more logf and six f32 operations; all of it
    once per rung, and per step each of the rungs - 1 swaps' four f32
    operations and expf.  Accepted moves, gated structural steps and
    their prior terms depend on the data and are left out."""
    per_step_flops = (
        P * NB * (A - 1) * (10 * R + 5 * 32) + P * R * (3 * P - 2) + P * NB * R
    )
    per_step_tr = P * NB * (A - 1) * 2 * R + P * R * P
    if prior:
        per_step_flops += P * NB * (A - 1) * 6
        per_step_tr += P * NB * (A - 1) * 2
    per_step_flops = per_step_flops * rungs + 4 * (rungs - 1)
    per_step_tr = per_step_tr * rungs + (rungs - 1)
    nbytes = (
        4 * (S * NB * A * R + S * R + S * NB + S + C + P * NB * C + T * C)
        + 4 * S * prior + trace_bytes * T * NB * C
    )
    return _work(per_step_flops * C * T, per_step_tr * C * T, nbytes)


def _calling_work(P, R, H, S, C, T):
    """K2 per launch, counted from calling_sampler.cu: per slot the other
    slots' e summed per read, then per candidate and read an add, a
    logf, an add and a multiply-add, and per candidate log1pf, two logf
    for the Gumbel draw and two operations."""
    per_step_flops = P * (R * max(P - 2, 0) + H * (4 * R + 2))
    per_step_tr = P * H * (R + 3)
    nbytes = 4 * (S * R * H + S * R + S + C + T * C) + T * P * C
    return _work(per_step_flops * C * T, per_step_tr * C * T, nbytes)


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


def phase_d(device, card):
    """K1 and plain throughput at the de novo bench shape."""
    import numpy as np

    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, A, R, C, STEPS, S = 4, 16, 2, 64, 16384, 200, 64
    rng = np.random.default_rng(7)
    args = _inputs(rng, S, P, NB, A, R, C, device)
    K.denovo_sampler(*args, n_steps=2)  # warm-up
    k_ms = _time_cuda(lambda: K.denovo_sampler(*args, n_steps=STEPS, seed=3), 3)
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


def _calling_inputs(rng, S, P, H, R, C, device, NB=12, n_valid=None):
    """Per-problem read x haplotype log-probabilities [S, R, H] of reads
    simulated from P of a random H-haplotype panel over NB SNVs.  With
    ``n_valid`` (cycled over the problems), problem s keeps its first
    n_valid[s] haplotypes and its other columns are MIN_LOG padding, as
    ``fit_calling_multi`` pads a block's panels to the largest."""
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
    prob = (np.arange(C) % S).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (rh, counts, n_valid, prob)]


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
        frac = same.float().mean().item()
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
        if frac < 0.99 or err > 1e-3 or rec_err > 1e-2 or padded:
            _fail(f"phase E ({label})")
        worst = max(worst, err)
    return worst


def phase_f(device):
    """K2 with in-kernel Philox vs exact enumeration (TV < 0.03) on the
    problem of scripts/gate_pallas_calling.py."""
    import numpy as np
    import torch

    from mchap_tpu_torch.numerics.combinadics import genotype_alleles_as_index
    from mchap_tpu_torch.ops import cuda_calling as KC
    from mchap_tpu_torch.ops import exact
    from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik
    from mchap_tpu_torch.testing import simulate_reads

    P = 4
    panel = np.array([[0, 0, 0], [0, 1, 1], [1, 1, 0], [1, 1, 1]], np.int8)
    reads = simulate_reads(panel[[0, 1, 1, 3]], n_alleles=2, n_reads=8,
                           errors=False, uniform_sample=True, qual=(20, 20), seed=7)
    want = exact.genotype_posteriors(exact.genotype_likelihoods(reads, P, panel)).numpy()
    C, STEPS, BURN = 1024, 3000, 500
    rh = read_hap_loglik(prepare_reads(reads), panel).float()[None].to(device)
    g, _ = KC.calling_sampler(
        rh.contiguous(), torch.ones((1, rh.shape[1]), device=device),
        torch.tensor([len(panel)], dtype=torch.int32, device=device),
        torch.zeros(C, dtype=torch.int32, device=device),
        n_steps=STEPS, ploidy=P, seed=13,
    )
    flat = g[BURN:].permute(0, 2, 1).reshape(-1, P).long().cpu().numpy()
    got = np.bincount(genotype_alleles_as_index(flat), minlength=len(want)) / len(flat)
    tv = 0.5 * np.abs(got - want).sum()
    print(f"phase F: TV(K2, exact) = {tv:.4f} (bound 0.03)", flush=True)
    if not tv < 0.03:
        _fail("phase F")
    return tv


def phase_g(device, data, extra=()):
    """``mchap call`` at default settings through the CLI entry point:
    phase C's reads, with phase C's output VCF as the haplotype panel
    (MCHap's documented two-step workflow)."""
    from test_torch_fixtures import parse_vcf_records

    n_loci = 20
    argv = [
        "mchap", "call", "--bam", *data["bams"], "--ploidy", "4",
        "--haplotypes", str(data["assembled"]), "--reference", data["reference"],
        *extra,
    ]
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
    if (rc != 0 or len(records) != n_loci or k2 < 1 or incomplete
            or total != 440 or frac < 0.90):
        _fail("phase G")
    return launches


def phase_h(device, card):
    """K2 and plain throughput at the calling bench shape."""
    import numpy as np

    from mchap_tpu_torch.ops import cuda_calling as KC

    P, H, R, S, C, STEPS = 4, 16, 64, 64, 65536, 500
    rng = np.random.default_rng(11)
    args = _calling_inputs(rng, S, P, H, R, C, device)
    KC.calling_sampler(*args, n_steps=2, ploidy=P)  # warm-up
    k_ms = _time_cuda(lambda: KC.calling_sampler(*args, n_steps=STEPS, ploidy=P, seed=3), 3)
    plain_steps = 5
    KC.calling_sampler_plain(*args, n_steps=1, ploidy=P)
    p_ms = _time_cuda(
        lambda: KC.calling_sampler_plain(*args, n_steps=plain_steps, ploidy=P, seed=3), 1
    )
    work = _calling_work(P, R, H, S, C, STEPS)
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


def phase_n(device, STEPS=300):
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
            T = 1 if temps is None else len(temps)
            D = K.draw_layout(P, NB, T)["D"]
            gen = torch.Generator(device=device)
            gen.manual_seed(A + 10 * T)
            noise = torch.rand((STEPS, D, C), generator=gen, device=device)
            if alpha == PHASE_P_ALPHAS:
                alpha_t = torch.tensor(_phase_p_alphas(S, A), device=device)
            else:
                alpha_t = None if alpha is None else torch.full((S,), alpha, device=device)
            kw = dict(n_steps=STEPS, noise=noise, temps=temps, alpha=alpha_t)
            t_k, l_k = K.denovo_sampler(*args, **kw)
            with torch.inference_mode():  # less dispatch work per plain-version op
                t_p, l_p = K.denovo_sampler_plain(*args, **kw)
            torch.cuda.synchronize()
            same = (t_k == t_p).all(dim=0).all(dim=0)  # [C]
            frac = same.float().mean().item()
            err = (l_k - l_p).abs()[:, same].max().item()
            rec = _recompute_llks(t_k, args[0], args[5], P, A)
            rec_err = (rec - l_k.double()).abs().max().item()
            moved = (t_k[1:] != t_k[:-1]).any(dim=1).float().mean().item()
            by_prior = 1.0
            if alpha_t is not None:
                t_f, _ = K.denovo_sampler(*args, **dict(kw, alpha=None))
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


def phase_q(device, card, C=16384, STEPS=200):
    """K1 and plain throughput at phase D's shape with 4 rungs and the
    prior."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, A, R, S = 4, 16, 2, 64, 64
    temps = [0.25, 0.5, 0.75, 1.0]
    rng = np.random.default_rng(7)
    args = _inputs(rng, S, P, NB, A, R, C, device)
    kw = dict(temps=temps, alpha=torch.full((S,), 0.05, device=device))
    K.denovo_sampler(*args, n_steps=2, **kw)  # warm-up
    k_ms = _time_cuda(lambda: K.denovo_sampler(*args, n_steps=STEPS, seed=3, **kw), 3)
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
    ]
    for name, run in runners:
        t = time.perf_counter()
        results[name] = run()
        print(f"time: phase {name} {time.perf_counter() - t:.1f} s", flush=True)

    torch.cuda.synchronize()
    main_paths = (results["C"][0], results["G"], results["L"])
    err_i, i = results["I"]
    kernels = [
        dict(name="denovo_sampler", source="mchap_tpu_torch/csrc/denovo_sampler.cu",
             replaces="mchap_tpu/ops/pallas_denovo.py:270",
             launches=main_paths[0]["denovo_sampler"], max_abs_err=results["A"],
             **results["D"], modes_launches=results["P"][0]["denovo_sampler"],
             modes_max_abs_err=results["N"], **results["Q"]),
        dict(name="calling_sampler", source="mchap_tpu_torch/csrc/calling_sampler.cu",
             replaces="mchap_tpu/ops/pallas_calling.py:55",
             launches=main_paths[1]["calling_sampler"], max_abs_err=results["E"],
             **results["H"]),
        dict(name="mutation_sweep", source="mchap_tpu_torch/csrc/denovo_sampler.cu",
             replaces="mchap_tpu/ops/pallas_denovo.py:76",
             launches=sum(p["mutation_sweep"] for p in main_paths),
             max_abs_err=err_i, **i),
        dict(name="pedigree_sampler", source="mchap_tpu_torch/csrc/pedigree_sampler.cu",
             replaces="mchap_tpu/ops/pallas_pedigree.py:609",
             launches=results["L"]["pedigree_sampler"], max_abs_err=results["J"],
             **results["M"]),
    ]
    for k in kernels:
        k["route"] = "cuda"
        k["library_ms"] = None  # no single PyTorch call computes a sampler step
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
