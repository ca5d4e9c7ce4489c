"""Split K2's chain-step time on a GPU with clock64() counters.

Usage: python -m mchap_tpu_torch.profile_k2 [--root DIR] [--shapes H V]

Copies DIR/mchap_tpu_torch/csrc/calling_sampler.cu (DIR: this checkout
by default; give an unpacked older commit to profile its kernel) into
``.build/profile_k2/`` with counters, builds the copy with nvcc for
sm_90a and runs it through DIR's own wrapper in place of the kernel
library.  Lane 0 of each chain's warp adds the cycles of each stage of a
step to a shared-memory counter of its warp; each warp adds its counters
to the device's at its end.  A source that carries its own ``K2_PROF``
hooks is built with ``-DK2_PROFILE``; the lane-per-candidate source of
commit f5e425a, which has none, gets its counters inserted at fixed
anchors (a missing anchor stops the script), so that the profile of that
kernel in PERF.md can be made again.

Reported in cycles per chain-step, with each stage's share:

- ``srest``: the other slots' cached e summed per read, for every slot
  (f5e425a; the redesign rebuilds S_rest in ``eupd``);
- ``cand``: the candidate read pass (logf terms and their sums);
- ``gumbel``: log1p of the copies, the Gumbel draw's two logf and the
  running best (the redesign: log1p from its table, the score and the
  running best);
- ``philox``: the Philox4x32-10 call (or the pinned noise's load) and, in
  the redesign, its four words' Gumbel logf and the shuffles that hand
  them to the candidates' lanes (the next step's, made in this one);
- ``bfly``: the butterflies (the read groups' sum and the arg-max);
- ``eupd``: the chosen allele's e written to the slot's cache (and, in
  the redesign, the next slot's S_rest);
- ``trace``: the sorted genotype and llk written to the trace.

Shapes: phase H's (65,536 chains, P4, R64, H16, 64 problems) and phase
V's (``chip_smoke.LATENCY_K2``, phase G's launch).  Then the
uninstrumented kernel of DIR is timed at each and ptxas's lines for its
instances are printed.  Prints the card's name and power limit first.
Needs one GPU and nvcc.
"""

import argparse
import ctypes
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

from mchap_tpu_torch import profile_k1

HERE = pathlib.Path(__file__).resolve().parents[1]
OUT = HERE / ".build" / "profile_k2"
STAGES = ["srest", "cand", "gumbel", "philox", "bfly", "eupd", "trace"]
N_COUNTERS = 8  # STAGES, then the whole step
TOTAL = 7
STEPS = {"H": (20, 500), "V": (100, 2000)}  # label: steps instrumented, timed

_HEAD = """\
#define K2P_N 8
__device__ unsigned long long g_prof[K2P_N];
__shared__ unsigned long long prof_s[8][K2P_N];
#define PROF_ADD(i, v) if ((threadIdx.x & 31) == 0) prof_s[threadIdx.x >> 5][i] += (v);
#define MARK(i) { long long n_ = clock64(); PROF_ADD(i, n_ - tm) tm = n_; }
#define MARKR(a) { long long n_ = clock64(); a += n_ - tm; tm = n_; }
"""

_READ = profile_k1._READ.replace("K1P_N", "K2P_N")


def instrument_lane_per_candidate(src):
    """Counters at fixed anchors of the lane-per-candidate kernel (f5e425a)."""
    ins = profile_k1._insert
    s = ins(src, "namespace {\n\nconstexpr unsigned kFull", _HEAD, before=True)
    s = ins(s, "  int g[P];\n", "  if (lane == 0) for (int i = 0; i < K2P_N; ++i)"
            " prof_s[warp][i] = 0;\n", before=True)
    s = ins(s, "  for (int step = 0; step < p.n_steps; ++step) {\n    float llk = 0.f;\n",
            "    long long tm = clock64(), a_cand = 0, a_gum = 0, a_phi = 0;\n"
            "    const long long t_step = tm;\n")
    s = ins(s, "        srest[r] = acc;\n      }\n      __syncwarp();\n", "      MARK(0)\n")
    s = ins(s, "        int copies = 0;\n", "        MARKR(a_cand)\n", before=True)
    s = ins(s, "        const float logit = __fadd_rn(l, log1pf((float)copies));\n",
            "        MARKR(a_gum)\n")
    s = ins(s, "        const float u = uniform<P>(p, c, step, k, h);\n", "        MARKR(a_phi)\n")
    s = ins(s, "          best_s = score; best_h = h; best_l = l;\n        }\n      }\n",
            "      MARKR(a_gum)\n")
    s = ins(s, "      if (best_h == kNoAllele) best_h = 0;", "      MARK(4)\n", before=True)
    s = ins(s, "es[k * R + r] = __ldg(e + (size_t)r * H + best_h);\n      __syncwarp();\n",
            "      MARK(5)\n")
    s = ins(s, "    // trace: the sorted genotype", "    PROF_ADD(1, a_cand) PROF_ADD(2, a_gum)"
            " PROF_ADD(3, a_phi)\n    tm = clock64();\n", before=True)
    s = ins(s, "    if (lane == 0) p.llks[(size_t)step * p.C + c] = llk;\n  }\n",
            "  if (lane == 0)\n    for (int i = 0; i < K2P_N; ++i)"
            " atomicAdd(&g_prof[i], prof_s[warp][i]);\n")
    s = ins(s, "    if (lane == 0) p.llks[(size_t)step * p.C + c] = llk;\n",
            "    MARK(6)\n    PROF_ADD(7, clock64() - t_step)\n")
    return ins(s, "}  // namespace\n", _READ)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="tree whose kernel and wrapper to profile")
    ap.add_argument("--shapes", nargs="+", default=list(STEPS), choices=list(STEPS))
    a = ap.parse_args()
    root = a.root.resolve()
    cs = profile_k1._load_chip_smoke()  # this tree's shapes and timer
    sys.path[:0] = [str(root), str(HERE / "tests")]
    for name in [m for m in sys.modules if m.startswith("mchap_tpu_torch")]:
        del sys.modules[name]

    import torch

    from mchap_tpu_torch.ops import cuda_calling as KC
    from mchap_tpu_torch.ops import nvcc_build

    print(cs._card_line(), flush=True)
    dev = torch.device("cuda", 0)
    src = (root / "mchap_tpu_torch/csrc/calling_sampler.cu").read_text()
    with ThreadPoolExecutor(1) as pool:  # the two builds at once
        if "K2_PROF" in src:
            built = pool.submit(profile_k1.build, _HEAD + src + _READ, ("K2_PROFILE",),
                                "calling_sampler", OUT)
        else:
            built = pool.submit(profile_k1.build, instrument_lane_per_candidate(src), (),
                                "calling_sampler", OUT)
        KC.load_library()  # the uninstrumented kernel, through the tree's own build
        so = built.result()
    print(f"ptxas ({root.name}):", flush=True)
    for line in profile_k1._ptxas_lines(KC.build_log_path().read_text()):
        if "calling_kernel" in line:
            print("   ", line, flush=True)
    inputs = {label: cs.k2_shape(label, dev) for label in a.shapes}
    for label in a.shapes:
        args, P = inputs[label]
        ms = cs.time_k2(args, P, STEPS[label][1])
        C = args[3].shape[0]
        print(f"{label}: {C} chains, uninstrumented {ms:.4f} ms/step ="
              f" {C / (ms / 1e3):.4g} chain-steps/s", flush=True)

    KC._lib = None
    build_library = nvcc_build.build_library
    nvcc_build.build_library = lambda *a, **k: ctypes.CDLL(str(so))
    lib = KC.load_library()
    nvcc_build.build_library = build_library
    lib.prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * N_COUNTERS)()
    for label in a.shapes:
        args, P = inputs[label]
        steps = STEPS[label][0]
        C = args[3].shape[0]
        KC.calling_sampler(*args, n_steps=2, ploidy=P)
        lib.prof_read(ctypes.addressof(buf))  # zero the counters
        ms = cs._time_cuda(lambda: KC.calling_sampler(*args, n_steps=steps, ploidy=P,
                                                      seed=3), 1)
        lib.prof_read(ctypes.addressof(buf))
        b = [x / (C * steps) for x in buf]
        total = b[TOTAL]
        print(f"{label}: {C} chains x {steps} steps, instrumented {ms / steps:.4f} ms/step;"
              f" cycles per chain-step {total:.0f} (stages sum to"
              f" {sum(b[:TOTAL]) / total:.1%})", flush=True)
        print("    " + ", ".join(f"{n} {v:.0f} ({v / total:.1%})"
                                 for n, v in zip(STAGES, b)), flush=True)


if __name__ == "__main__":
    main()
