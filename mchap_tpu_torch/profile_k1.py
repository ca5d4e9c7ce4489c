"""Split K1's chain-step time on a GPU with clock64() counters.

Usage: python -m mchap_tpu_torch.profile_k1 [--root DIR]

Copies DIR/mchap_tpu_torch/csrc/denovo_sampler.cu (DIR: this checkout
by default; give an unpacked older commit to profile its kernel) into
``.build/profile_k1/`` with counters, builds the copy with nvcc for
sm_90a (its flat single-rung instance) and runs it through DIR's own
wrapper in place of the kernel library.  Lane 0 of each chain's warp
adds the cycles of each stage of a step to a shared-memory counter of
its warp; each warp adds its counters to the device's at its end.  A
source that carries its own ``K1_PROF`` hooks is built with
``-DK1_PROFILE``; the warp-per-chain source of commit 86902b5 gets its
counters inserted at fixed anchors.

Reported in cycles per chain-step, with each stage's share:

- ``refresh``: the rh rebuild and full llk (every 64 steps);
- the mutation sweep: ``rest`` (the other rows' logsumexp, per row),
  ``rowcmp`` (each row's equality counts with the other rows), ``site``
  (a site's setup: its column, counts and draw), ``cand`` (the pass
  over reads), ``bfly`` (the butterfly), ``decide`` (the MH decision and
  the accepted move);
- ``breaks``: the step's Bernoulli interval partition;
- ``isums``: the per-segment interval sums;
- for the recombination MH (``rec``), the partial dosage MH (``dos``)
  and the full-length dosage MH (``full``): ``eq`` (row equality inside
  and outside the interval), ``opts`` (the valid options and their
  reverse-move counts), ``reads`` (the pass over reads and the
  butterflies), ``accept`` (the acceptance walk) and ``apply``;
- ``trace``: the trace write.

Shapes: phase D's (16,384 chains, P4, NB16, A2, R64, 64 problems) and
the latency shape of phase C's launches (``chip_smoke.LATENCY``: 440
problems x 2 chains, P4, NB48, A3, R64).  Then the uninstrumented
kernel of DIR is timed at both and ptxas's lines for its instances are
printed.  Prints the card's name and power limit first.  Needs one GPU
and nvcc.
"""

import argparse
import ctypes
import importlib.util
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parents[1]
OUT = HERE / ".build" / "profile_k1"
STAGES = [
    "refresh",
    "mut.rest", "mut.rowcmp", "mut.site", "mut.cand", "mut.bfly", "mut.decide",
    "breaks", "isums",
    "rec.eq", "rec.opts", "rec.reads", "rec.accept", "rec.apply",
    "dos.eq", "dos.opts", "dos.reads", "dos.accept", "dos.apply",
    "full.eq", "full.opts", "full.reads", "full.accept", "full.apply",
    "swaps", "trace",
]
N_COUNTERS = 32  # STAGES, then the whole step at index 30
TOTAL = 30
SHAPES = [  # label, steps (instrumented), steps (timed)
    ("D", 20, 200),
    ("latency", 100, 200),
]

_HEAD = """\
#define K1P_N 32
__device__ unsigned long long g_prof[K1P_N];
__shared__ unsigned long long prof_s[8][K1P_N];
#define PROF_ADD(i, v) if ((threadIdx.x & 31) == 0) prof_s[threadIdx.x >> 5][i] += (v);
#define MARK(i) { long long n_ = clock64(); PROF_ADD(i, n_ - tm) tm = n_; }
#define MARKR(a) { long long n_ = clock64(); a += n_ - tm; tm = n_; }
"""

_READ = """\
extern "C" int prof_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  const int e = cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * K1P_N);
  unsigned long long z[K1P_N] = {};
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return e;
}
"""


def _insert(src, anchor, text, before=False):
    if src.count(anchor) != 1:
        raise SystemExit(f"profile_k1: anchor found {src.count(anchor)} times: {anchor!r}")
    return src.replace(anchor, text + anchor if before else anchor + text)


def instrument_warp_per_chain(src):
    """Counters at fixed anchors of the warp-per-chain kernel (86902b5)."""
    s = _insert(src, "namespace {\n\nconstexpr float kNegBig", _HEAD, before=True)
    # mutation sweep: per-site stages in registers, added once per sweep
    s = _insert(s, "  float* rest = ch.rhi;  // rhi row 0 is free during the mutation sweep\n",
                "  long long tm = clock64(), a_rest = 0, a_d = 0, a_site = 0, a_cand = 0,"
                " a_bfly = 0, a_dec = 0;\n")
    s = _insert(s, "    // d[h2]: positions where row h2 equals row h", "    MARKR(a_rest)\n",
                before=True)
    s = _insert(s, "#pragma unroll 1\n    for (int j = 0; j < NB; ++j) {\n      const int cur",
                "    MARKR(a_d)\n", before=True)
    s = _insert(s, "      const float u = ch.uni(step, h * NB + j);\n", "      MARKR(a_site)\n")
    s = _insert(s, "        const float llk_alt = warp_sum(part);\n", "        MARKR(a_cand)\n",
                before=True)
    s = _insert(s, "        const float llk_alt = warp_sum(part);\n", "        MARKR(a_bfly)\n")
    s = _insert(s, "          const float llk_a = warp_sum(part);\n", "          MARKR(a_cand)\n",
                before=True)
    s = _insert(s, "          const float llk_a = warp_sum(part);\n", "          MARKR(a_bfly)\n")
    s = _insert(s, "          if (chosen < 0 && acc > u) { chosen = a; chosen_llk = llk_a; }\n",
                "          MARKR(a_dec)\n")
    s = _insert(s, "        if (ch.lane == 0) ch.g[h * NB + j] = (int8_t)new_a;\n"
                   "        __syncwarp();\n      }\n", "      MARKR(a_dec)\n")
    s = _insert(s, "  return llk;\n}\n\n// -----", "  PROF_ADD(1, a_rest) PROF_ADD(2, a_d)"
                " PROF_ADD(3, a_site) PROF_ADD(4, a_cand) PROF_ADD(5, a_bfly)"
                " PROF_ADD(6, a_dec)\n", before=True)
    # structural MH: five stages each
    s = _insert(s, "  const int R = p.R, NB = p.NB;\n  // row equality inside / outside",
                "  long long tm = clock64();\n"
                "  constexpr int PB = FULL ? 19 : KIND == 0 ? 9 : 14;\n", before=True)
    s = _insert(s, "  uint64_t valid = 0;\n", "  MARK(PB)\n", before=True)
    s = _insert(s, "  const int n_options = count_options<P, KIND>(lab_in, lab_out, &valid);\n",
                "  MARK(PB + 1)\n")
    s = _insert(s, "  // MH acceptance with the n_options", "  MARK(PB + 2)\n", before=True)
    s = _insert(s, "  if (!(u < acc) || chosen < 0) return llk;\n", "  MARK(PB + 3)\n",
                before=True)
    s = _insert(s, "  return chosen_llk;\n}\n", "  MARK(PB + 4)\n", before=True)
    # the chain loop
    s = _insert(s, "  if (c >= p.C) return;\n\n  Chain ch = load_chain<P>(p, smem, warp, c);\n",
                "  if (ch.lane == 0) for (int i = 0; i < K1P_N; ++i) prof_s[warp][i] = 0;\n")
    s = _insert(s, "  for (int step = 0; step < p.n_steps; ++step) {\n",
                "    long long tm = clock64();\n    const long long t_step = tm;\n")
    s = _insert(s, "      llk = full_llk<P>(ch, log_p);\n    }\n", "    MARK(0)\n")
    s = _insert(s, "    llk = mutation_sweep<P>(ch, step, llk, log_p, temp);\n",
                "    tm = clock64();\n")
    s = _insert(s, "          ch.seg[j] = (int8_t)acc;\n        }\n      }\n      __syncwarp();\n",
                "      MARK(7)\n")
    s = _insert(s, "        int perm[P];\n", "        MARK(8)\n", before=True)
    s = _insert(s, "        llk = structural_mh<P, 0, false>(ch, i, len_in, gate_r, u_r, llk,"
                   " log_p, temp, perm);\n", "        tm = clock64();\n")
    s = _insert(s, "                                           perm);\n", "        tm = clock64();\n")
    s = _insert(s, "                                      log_p, temp, perm);\n",
                "      tm = clock64();\n")
    s = _insert(s, "    // trace write: base-packed", "    MARK(24)\n", before=True)
    s = _insert(s, "    if (ch.lane == 0) p.llks[(size_t)step * p.C + c] = llk;\n",
                "    MARK(25)\n    PROF_ADD(30, clock64() - t_step)\n")
    s = _insert(s, "    if (ch.lane == 0) p.llks[(size_t)step * p.C + c] = llk;\n    MARK(25)\n"
                   "    PROF_ADD(30, clock64() - t_step)\n  }\n",
                "  if (ch.lane == 0)\n    for (int i = 0; i < K1P_N; ++i)"
                " atomicAdd(&g_prof[i], prof_s[warp][i]);\n")
    return _insert(s, "}  // namespace\n", _READ)


def build(src, defines=(), stem="denovo_sampler", out=OUT):
    """nvcc ``src`` for sm_90a into ``out/lib<stem>_prof.so``."""
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{stem}_prof.cu", out / f"lib{stem}_prof.so"
    cu.write_text(src)
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         *(f"-D{d}" for d in defines), "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"profile: nvcc failed on {stem}:\n{proc.stderr[-4000:]}")
    return so


def _ptxas_lines(log_text):
    kernel, out = None, []
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Function properties for" in line:
            kernel = line.split("Function properties for")[-1].strip()
        elif kernel and ("registers" in line or "stack frame" in line):
            out.append(f"{kernel}: {line.split('info    :')[-1].strip()}")
    return out


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="tree whose kernel and wrapper to profile")
    root = ap.parse_args().root.resolve()
    cs = _load_chip_smoke()  # this tree's shapes and timer
    sys.path[:0] = [str(root), str(HERE / "tests")]
    for name in [m for m in sys.modules if m.startswith("mchap_tpu_torch")]:
        del sys.modules[name]

    import numpy as np
    import torch

    from mchap_tpu_torch.ops import cuda_denovo as K
    from mchap_tpu_torch.ops import nvcc_build

    print(cs._card_line(), flush=True)
    dev = torch.device("cuda", 0)
    shapes = {
        "D": lambda: cs._inputs(np.random.default_rng(7), 64, 4, 16, 2, 64, 16384, dev),
        "latency": lambda: cs._latency_inputs(np.random.default_rng(5), dev),
    }

    src = (root / "mchap_tpu_torch/csrc/denovo_sampler.cu").read_text()
    with ThreadPoolExecutor(1) as pool:  # the two builds at once
        if "K1_PROF" in src:
            built = pool.submit(build, _HEAD + src + _READ, ("K1_PROFILE",))
        else:
            built = pool.submit(build, instrument_warp_per_chain(src))
        K.load_library()  # the uninstrumented kernel, through the tree's own build
        so = built.result()
    print(f"ptxas ({root.name}):", flush=True)
    for line in _ptxas_lines(K.build_log_path().read_text()):
        if "denovo_kernel" in line:
            print("   ", line, flush=True)
    for label, _, steps in SHAPES:
        args = shapes[label]()
        K.denovo_sampler(*args, n_steps=2)
        ms = cs._time_cuda(lambda: K.denovo_sampler(*args, n_steps=steps, seed=3), 3)
        C = args[2].shape[2]
        print(f"{label}: {C} chains x {steps} steps, uninstrumented {ms / steps:.4f} ms/step"
              f" = {C * steps / (ms / 1e3):.4g} chain-steps/s", flush=True)

    K._libs.clear()
    build_library = nvcc_build.build_library
    nvcc_build.build_library = lambda *a, **k: ctypes.CDLL(str(so))
    lib = K.load_library()
    nvcc_build.build_library = build_library
    lib.prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * N_COUNTERS)()
    for label, steps, _ in SHAPES:
        args = shapes[label]()
        C = args[2].shape[2]
        K.denovo_sampler(*args, n_steps=2)
        lib.prof_read(ctypes.addressof(buf))  # zero the counters
        ms = cs._time_cuda(lambda: K.denovo_sampler(*args, n_steps=steps, seed=3), 1)
        lib.prof_read(ctypes.addressof(buf))
        b = [x / (C * steps) for x in buf]
        total = b[TOTAL]
        print(f"{label}: {C} chains x {steps} steps, instrumented {ms / steps:.4f} ms/step;"
              f" cycles per chain-step {total:.0f} (stages sum to"
              f" {sum(b[:len(STAGES)]) / total:.1%})", flush=True)
        groups = {}
        for name, v in zip(STAGES, b):
            groups.setdefault(name.split(".")[0], []).append((name, v))
        for g, items in groups.items():
            print("    " + ", ".join(f"{n} {v:.0f} ({v / total:.1%})" for n, v in items),
                  flush=True)


if __name__ == "__main__":
    main()
