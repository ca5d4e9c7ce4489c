"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (needs CUDA; exits nonzero without it)

Builds the port's CUDA kernel (K1, the de novo sampler) from
``mchap_tpu_torch/csrc`` and runs four phases, each printing one line:

A. kernel vs its plain PyTorch version on the card, pinned noise;
B. kernel with its own Philox stream vs exact enumeration;
C. ``mchap assemble`` end to end through the port's CLI entry point on
   a synthetic 22-sample x 20-locus tetraploid dataset, counting K1
   launches and checking genotype calls against the truth;
D. kernel and plain throughput at 16,384 chains x 200 steps.

The line before last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises.
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


def _problems(rng, n_problems, P, NB, A, R, error_rate=0.0024):
    """Per-problem log reads [S, NB, A, R] simulated from random haplotypes."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops.likelihood import prepare_reads
    from mchap_tpu_torch.testing import simulate_reads

    lr = np.zeros((n_problems, NB, A, R), np.float32)
    for s in range(n_problems):
        haps = rng.integers(0, A, size=(P, NB))
        reads = simulate_reads(
            haps, n_alleles=A, n_reads=R, errors=True, error_rate=error_rate,
            seed=int(rng.integers(1 << 30)),
        )
        lr[s] = prepare_reads(reads, dtype=torch.float32).numpy().transpose(1, 2, 0)
    return lr


def _inputs(rng, S, P, NB, A, R, C, device):
    import numpy as np
    import torch

    lr = _problems(rng, S, P, NB, A, R)
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


def phase_c(device):
    """``mchap assemble`` at default settings through the CLI entry point.

    Synthetic dataset at the size of the reference's bundled bi-parental
    example: 22 tetraploid samples, 20 loci, 866 SNVs (5 triallelic),
    64 amplicon reads per sample and locus with base errors at the
    default rate, genotypes drawn from 6 founder haplotypes per locus
    that differ from the reference at 6 SNVs each.
    """
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_fixtures import called_haplotypes, parse_vcf_records, write_dataset

    from mchap_tpu_torch.application.cli import main as cli_main
    from mchap_tpu_torch.constant import PFEIFFER_ERROR
    from mchap_tpu_torch.ops import cuda_denovo as K
    from mchap_tpu_torch.utils import timing

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
        "--reference", data["reference"],
    ]
    os.environ["MCHAP_TIMING"] = "1"
    timers = timing.reset()
    out = io.StringIO()
    K.denovo_sampler.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    launches = K.denovo_sampler.launches
    (WORK / "assemble" / "out.vcf").write_text(out.getvalue())
    records = parse_vcf_records(out.getvalue())
    agree = total = 0
    for rec in records:
        for sample, haps in called_haplotypes(rec).items():
            total += 1
            agree += haps == data["truth"][rec["ID"]][sample]
    frac = agree / max(total, 1)
    print(
        f"phase C: assemble exit {rc}, {len(records)} records, K1 launches"
        f" {launches}, GT == truth {agree}/{total} = {frac:.4f} (bound 0.90);"
        f" wall {wall:.2f} s = {n_loci / wall:.3f} loci/s",
        flush=True,
    )
    for line in timers.summary_lines():
        print("phase C timing:", line, flush=True)
    if rc != 0 or len(records) != n_loci or launches < 1 or total != 440 or frac < 0.90:
        _fail("phase C")
    return launches


def phase_d(device):
    """Kernel and plain throughput at the de novo bench shape."""
    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K

    P, NB, A, R, C, STEPS = 4, 16, 2, 64, 16384, 200
    rng = np.random.default_rng(7)
    args = _inputs(rng, 64, P, NB, A, R, C, device)
    K.denovo_sampler(*args, n_steps=2)  # warm-up
    k_ms = _time_cuda(lambda: K.denovo_sampler(*args, n_steps=STEPS, seed=3), 3)
    plain_steps = 20
    K.denovo_sampler_plain(*args, n_steps=1)
    p_ms = _time_cuda(
        lambda: K.denovo_sampler_plain(*args, n_steps=plain_steps, seed=3), 1
    )
    k_rate = C * STEPS / (k_ms / 1e3)
    p_rate = C * plain_steps / (p_ms / 1e3)
    print(
        f"phase D: {C} chains P{P} NB{NB} A{A} R{R}: kernel {k_ms:.1f} ms for"
        f" {STEPS} steps = {k_rate:.4g} chain-steps/s; plain {p_ms:.1f} ms for"
        f" {plain_steps} steps = {p_rate:.4g} chain-steps/s",
        flush=True,
    )
    return k_ms / STEPS, p_ms / plain_steps


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false; this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    from mchap_tpu_torch.ops import cuda_denovo as K

    device = torch.device("cuda", 0)
    print(_card_line(), flush=True)
    t0 = time.perf_counter()
    K.load_library()
    print(f"build: K1 built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in K.build_log_path().read_text().splitlines():
        if "Used" in line and "registers" in line:
            print("ptxas:", line.split("info    :")[-1].strip())

    err_a = phase_a(device)
    phase_b(device)
    launches = phase_c(device)
    ms_step, plain_ms_step = phase_d(device)

    print(json.dumps({"kernels": [{
        "name": "denovo_sampler",
        "route": "cuda",
        "source": "mchap_tpu_torch/csrc/denovo_sampler.cu",
        "replaces": "mchap_tpu/ops/pallas_denovo.py:270",
        "launches": launches,
        "max_abs_err": err_a,
        "ms": ms_step,
        "plain_ms": plain_ms_step,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
