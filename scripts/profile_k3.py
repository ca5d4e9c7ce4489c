"""Split K3's step time on a GPU with clock64() counters.

Usage: python scripts/profile_k3.py [--root DIR]

Copies DIR/mchap_tpu_torch/csrc/pedigree_sampler.cu (DIR: this checkout
by default; give an unpacked older commit to profile its kernel) into
``.build/profile_k3/`` with counters added, builds the copy with nvcc for
sm_90a and runs it through DIR's own wrapper in place of the kernel
library.  One thread per chain (thread 0 of a chain's block, lane 0 of a
chain's warp in the warp-per-chain layout of commit 89d7e6b) adds the
cycles of each part of a step to a device counter.  Reported per
chain-step, on chip_smoke.py's 2 + 20 tetraploid family (R64, 16 SNVs):

- founders, progeny and pair swaps: the slot updates of samples with
  children and of samples without (in the block-per-chain layout: waves of
  one sample and longer waves, which here are the same split), then the
  pair swaps;
- block-per-chain layout only: each slot update's stages, by the size of
  the team that runs it (one warp, several, the whole block): Gumbel noise
  and copies, the reads' rest, the read terms, their sum, the trios
  (written and summed), the arg-max.  Thread 0's team only.

Shapes: phase M's 128 loci x 1 chain and x 128 chains (H16), and 20 loci
x 2 chains with 6 haplotypes (NB 44), the shape of phase L's launch.  For
the block-per-chain layout the uninstrumented kernel is then timed at 4,
8 and 16 warps per block and at ``warps_per_block``'s choice.  Prints the
card's name and power limit first.  Needs one GPU and nvcc.
"""

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / ".build" / "profile_k3"
N_COUNTERS = 22
STAGES = ["gumbel", "rest", "terms", "sum", "prior", "pick"]
SHAPES = [  # label, loci, chains per locus, steps, H, SNVs
    ("M latency", 128, 1, 50, 16, 16),
    ("L-like", 20, 2, 100, 6, 44),
    ("M full", 128, 128, 5, 16, 16),
]


def _insert(src, anchor, text, before=False):
    if src.count(anchor) != 1:
        raise SystemExit(f"profile_k3: anchor found {src.count(anchor)} times: {anchor!r}")
    return src.replace(anchor, text + anchor if before else anchor + text)


def instrument(src):
    """The source with counters: [0, 18) stages by team kind, 18 pair
    swaps, 19 founders, 20 progeny.  Returns (source, block layout?)."""
    block = "wave_ptr" in src
    root = "threadIdx.x" if block else "(threadIdx.x & 31)"
    head = (f"__device__ unsigned long long g_prof[{N_COUNTERS}];\n"
            f"#define ROOT_THREAD ({root} == 0)\n"
            "#define ADD(i, t0) if (ROOT_THREAD) atomicAdd(&g_prof[i], clock64() - (t0));\n"
            "#define MARK(b) if (ROOT_THREAD) { long long n = clock64();"
            " atomicAdd(&g_prof[kind + (b)], n - tm); tm = n; }\n")
    src = _insert(src, "namespace {\n\nconstexpr unsigned kFull", head, before=True)
    src = _insert(src, "    // parental-pair allele swaps", "    long long tsw = clock64();\n",
                  before=True)
    src = _insert(src, "    int16_t* out = p.trace", "    ADD(18, tsw)\n", before=True)
    if block:
        src = _insert(src, "  int best_h = 0x7fffffff;\n",
                      "  long long tm = clock64();\n"
                      "  const int kind = t.nw == 1 ? 0 : t.nw * 32 == (int)blockDim.x ? 12 : 6;\n")
        src = _insert(src, "    // i / cw as __umulhi", "    MARK(0)\n", before=True)
        src = _insert(src, "g_s, P, k);\n      t.sync();\n", "      MARK(1)\n")
        src = _insert(src, "cnt_s + r0 + r));\n      }\n      t.sync();\n", "      MARK(2)\n")
        src = _insert(src, "t.tile[r * cw + t.tid]);\n      }\n      t.sync();\n", "      MARK(3)\n")
        src = _insert(src, "    if (t.tid < cw)\n      keep_best(", "    MARK(4)\n", before=True)
        src = _insert(src, "sh.g[s * maxp + k] = best_h;\n  t.sync();\n", "  MARK(5)\n")
        src = _insert(src, "hi = __ldg(p.wave_ptr + wi + 1);\n", "      const long long tw = clock64();\n")
        src = _insert(src, "        __syncthreads();\n      }\n", "      ADD(hi - lo == 1 ? 19 : 20, tw)\n")
    else:
        src = _insert(src, "#pragma unroll 1\n      for (int k = 0; k < P; ++k) {\n",
                      "      const long long ts = clock64();\n", before=True)
        src = _insert(src, "g[s * maxp + k] = best_h;\n        __syncwarp();\n      }\n",
                      "      ADD(p.child_ptr[s + 1] > p.child_ptr[s] ? 19 : 20, ts)\n")
    src = _insert(src, "const char* pedigree_sampler_error_string", f"""\
int prof_read(unsigned long long* out) {{
  cudaDeviceSynchronize();
  const int e = cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * {N_COUNTERS});
  unsigned long long z[{N_COUNTERS}] = {{}};
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return e;
}}

""", before=True)
    return src, block


def build(src):
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "pedigree_sampler_prof.cu", OUT / "libpedigree_sampler_prof.so"
    cu.write_text(src)
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"profile_k3: nvcc failed:\n{proc.stderr[-4000:]}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "stack frame" in line:
            print("ptxas (instrumented):", line.split("info    :")[-1].strip(), flush=True)
    return so


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=ROOT,
                    help="tree whose kernel, wrapper and chip_smoke.py to use")
    root = ap.parse_args().root.resolve()
    sys.path[:0] = [str(root), str(root / "tests")]

    import numpy as np
    import torch

    import chip_smoke as cs
    from mchap_tpu_torch.ops import cuda_pedigree as K3
    from mchap_tpu_torch.ops import nvcc_build

    print(cs._card_line(), flush=True)
    src, block = instrument((root / "mchap_tpu_torch/csrc/pedigree_sampler.cu").read_text())
    dev = torch.device("cuda", 0)

    def inputs(loci, chains, H, nb):
        rng = np.random.default_rng(23)
        rh, counts, freqs, nv = cs._pedigree_inputs(rng, cs.BIPARENTAL, loci, dev, H=H, NB=nb)
        plan = cs._pedigree_plan(cs.BIPARENTAL)
        C = loci * chains
        prob = torch.arange(loci, dtype=torch.int32, device=dev).repeat_interleave(chains)
        init = rng.integers(0, H, (C, plan.n_samples, plan.max_ploidy)).astype(np.int32)
        return (rh, counts, freqs, nv, prob, torch.from_numpy(init).to(dev), plan), C

    if block:  # the uninstrumented kernel at several block sizes
        choose = K3.warps_per_block
        for label, loci, chains, steps, H, nb in SHAPES:
            args, C = inputs(loci, chains, H, nb)
            for warps in (4, 8, 16, None):
                # the wrapper asks warps_per_block for the block size
                K3.warps_per_block = choose if warps is None else (lambda *a, w=warps: w)
                K3.pedigree_sampler(*args, n_steps=2)
                ms = cs._time_cuda(lambda: K3.pedigree_sampler(*args, n_steps=4 * steps, seed=5), 2)
                shown = warps or f"{K3.launch_warps(args[-1], C, args[0].shape[2], dev)} (chosen)"
                print(f"{label}: {C} chains x {4 * steps} steps, H{H}, {shown} warps per block:"
                      f" {ms / (4 * steps):.4f} ms/step", flush=True)
        K3.warps_per_block = choose

    so = build(src)
    K3._lib = None
    nvcc_build.build_library = lambda name: ctypes.CDLL(str(so))
    lib = K3.load_library()
    lib.prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * N_COUNTERS)()
    for label, loci, chains, steps, H, nb in SHAPES:
        args, C = inputs(loci, chains, H, nb)
        K3.pedigree_sampler(*args, n_steps=2)
        lib.prof_read(ctypes.addressof(buf))  # zero the counters
        ms = cs._time_cuda(lambda: K3.pedigree_sampler(*args, n_steps=steps, seed=5), 1)
        lib.prof_read(ctypes.addressof(buf))
        b = [x / (C * steps) for x in buf]
        total = b[18] + b[19] + b[20]
        plan = args[-1]
        founders = sum(int(plan.ploidy[s]) for s in range(plan.n_samples) if plan.children[s])
        slots = int(plan.ploidy.sum())
        print(f"{label}: {C} chains x {steps} steps, H{H}, instrumented {ms / steps:.4f} ms/step;"
              f" cycles per chain-step: founders {b[19]:.0f} ({b[19] / total:.1%}), progeny"
              f" {b[20]:.0f} ({b[20] / total:.1%}), pair swaps {b[18]:.0f}"
              f" ({b[18] / total:.1%}); per founder slot {b[19] / founders:.0f}, per progeny"
              f" slot {b[20] / (slots - founders):.0f}", flush=True)
        if block:
            for kind, o in (("one-warp team", 0), ("multi-warp team", 6), ("block team", 12)):
                print(f"    {kind}: " + ", ".join(f"{n} {b[o + i]:.0f}" for i, n in enumerate(STAGES)),
                      flush=True)


if __name__ == "__main__":
    main()
