"""K4, the kernel of the torch de novo route: CUDA launch, wrapper and tables.

Replaces the jitted XLA program ``mchap_tpu/ops/assemble_mcmc.py::
denovo_sampler`` (jit :481; site scan :293, interval scan :432, step
scan :607), which ``mchap_tpu`` runs for the ``assemble`` blocks its
Pallas kernel refuses and K1 refuses here (``cuda_denovo.
k1_unsupported_reason``; ``DenovoMCMC(n_intervals=...)``).  Its plain
version is ``ops/assemble_mcmc.denovo_sampler``, the op-by-op torch
translation of that program: ``denovo_route_sampler`` takes its
arguments and returns its ``(genotypes int8[S, C, kept, P, NB], llks
f64[S, C, kept])``.

On CUDA tensors it launches ``csrc/denovo_route_sampler.cu`` (built at
first use by ``ops/nvcc_build``): one launch that fills the state, then
per step one launch over every row (chain-rung) and, with more than one
rung, a swap launch over chains, all issued from one C call with no
wait.  The kernel makes each draw itself, ``utils.philox.keyed_uniforms``
of row ``row_offset`` + row, so it walks the plain version's chain: the
same genotypes, llks equal to f64 rounding.  On CPU tensors the wrapper
runs the plain version.  Nothing falls back: a build failure, a refused
shape or a failed launch raises.

A row's state and workspace live in device memory (``row_bytes``); the
rows are run in pieces of whole chains that fit ``utils.device.
memory_budget`` (``rows_per_piece``), each piece keyed by its global rows,
so the split changes no draw.
"""

import ctypes
import math
import threading

import numpy as np
import torch

from mchap_tpu_torch.ops import assemble_mcmc as _plain
from mchap_tpu_torch.ops import nvcc_build
from mchap_tpu_torch.utils.device import memory_budget

MAX_PLOIDY = 64  # the kernel's row-equality sets are 64-bit masks
MAX_ALLELES = 8  # a lane's per-allele partial sums
_NAME = "denovo_route_sampler"
_F64 = torch.float64


def denovo_route_sampler(
    seed,
    row_offset,
    initial,
    log_reads,
    read_counts,
    n_alleles,
    break_dist,
    temperatures,
    *,
    n_steps,
    burn=0,
    inbreeding=None,
    recombination_step_probability=0.5,
    partial_dosage_step_probability=0.5,
    dosage_step_probability=1.0,
):
    """Batched de novo assembly MCMC: ``assemble_mcmc.denovo_sampler``'s
    parameters and result, on ``log_reads.device``.

    On a card this launches K4 (and raises if it cannot); on the CPU it
    runs the plain version.  Draw j of step s for row b (rows ordered
    (problem, chain, rung)) is ``keyed_uniforms(seed, row_offset + b, s)``
    draw j either way.
    """
    _check_inputs(initial, log_reads, read_counts, n_alleles, break_dist, temperatures,
                  inbreeding, n_steps, burn, row_offset)
    args = (seed, row_offset, initial, log_reads, read_counts, n_alleles, break_dist,
            temperatures)
    kw = dict(
        n_steps=n_steps, burn=burn, inbreeding=inbreeding,
        recombination_step_probability=recombination_step_probability,
        partial_dosage_step_probability=partial_dosage_step_probability,
        dosage_step_probability=dosage_step_probability,
    )
    if log_reads.device.type == "cuda":
        return _launch(*args, **kw)
    if log_reads.device.type != "cpu":
        raise ValueError(f"unsupported device {log_reads.device}")
    return _plain.denovo_sampler(*args, cuda_graph=False, **kw)


#: K4 kernel launches made through ``denovo_route_sampler`` (CUDA tensors
#: only): per piece of rows one state launch, then per step one step
#: launch and, with more than one rung, one swap launch
denovo_route_sampler.launches = 0


def _check_inputs(initial, log_reads, read_counts, n_alleles, break_dist, temperatures,
                  inbreeding, n_steps, burn, row_offset):
    if initial.dim() != 4 or log_reads.dim() != 4:
        raise ValueError("initial must be [S, C, P, NB] and log_reads [S, R, NB, A]")
    S, C, P, NB = initial.shape
    _, R, _, A = log_reads.shape
    expect = [
        ("initial", initial, (S, C, P, NB)),
        ("log_reads", log_reads, (S, R, NB, A)),
        ("read_counts", read_counts, (S, R)),
        ("n_alleles", n_alleles, (S, NB)),
        ("break_dist", break_dist, (S, NB)),
    ]
    if inbreeding is not None:
        expect.append(("inbreeding", inbreeding, (S,)))
    for name, t, shape in expect:
        if not torch.is_tensor(t):
            raise ValueError(f"{name} must be a tensor")
        if t.device != log_reads.device:
            raise ValueError(f"{name} is on {t.device}, log_reads on {log_reads.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if initial.is_floating_point() or initial.is_complex():
        raise ValueError(f"initial must hold integer alleles, got {initial.dtype}")
    if initial.numel() and not 0 <= int(initial.min()) <= int(initial.max()) < A:
        raise ValueError(f"initial alleles must lie in [0, {A})")
    if not 1 <= P <= MAX_PLOIDY:
        raise ValueError(f"ploidy {P} outside 1..{MAX_PLOIDY}")
    if not 1 <= A <= MAX_ALLELES:
        raise ValueError(f"{A} alleles outside 1..{MAX_ALLELES}")
    if NB < 1 or R < 1:
        raise ValueError("at least one position and one read bucket are needed")
    temps = np.asarray(temperatures, float).reshape(-1)
    if len(temps) < 1 or temps[-1] != 1.0 or np.any(np.diff(temps) < 0):
        raise ValueError("temperatures must ascend to a last rung of 1.0")
    if n_steps < 0 or burn < 0:
        raise ValueError("n_steps and burn must be >= 0")
    if not 0 <= row_offset < 2 ** 63:
        raise ValueError(f"row_offset {row_offset} outside [0, 2**63)")
    if S * C * len(temps) >= 2 ** 31:
        raise ValueError("a call runs fewer than 2**31 rows")


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_libs = {}
_lock = threading.Lock()


def build_log_path():
    return nvcc_build.log_path(_NAME)


def load_library():
    """Build (at first use) and load K4's library: ``nvcc`` compiles
    ``csrc/denovo_route_sampler.cu`` for sm_90a into ``.build/kernels/``.
    Raises if the build fails."""
    with _lock:
        if _NAME not in _libs:
            lib = nvcc_build.build_library(_NAME)
            lib.denovo_route_run.restype = ctypes.c_int
            lib.denovo_route_run.argtypes = [ctypes.c_void_p] * 4  # ptrs ints reals stream
            lib.denovo_route_row_words.restype = None
            lib.denovo_route_row_words.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int64)] * 3
            )
            lib.denovo_route_error_string.restype = ctypes.c_char_p
            lib.denovo_route_error_string.argtypes = [ctypes.c_int]
            _libs[_NAME] = lib
        return _libs[_NAME]


def row_words(lib, ploidy, n_base):
    """The kernel's own counts per row: (workspace ints, option doubles,
    draws per step)."""
    out = [ctypes.c_int64() for _ in range(3)]
    lib.denovo_route_row_words(ploidy, n_base, *(ctypes.byref(x) for x in out))
    return tuple(x.value for x in out)


def row_bytes(ploidy, n_base, n_reads, words):
    """Device bytes of one row: its state slot (genotype, rh, llk, slot
    index) and its workspace (draws, interval sums, options, ints)."""
    n_wi, n_opt, D = words
    P, NB, R = ploidy, n_base, n_reads
    return P * NB + 16 * P * R + 12 + 8 * (D + n_opt) + 4 * n_wi


def rows_per_piece(n_rows, n_temps, per_row, device):
    """Rows (whole chains of ``n_temps``) one piece may take within
    ``memory_budget``; at least one chain."""
    fit = memory_budget(device) // max(per_row, 1)
    return min(n_rows, max(n_temps, fit // n_temps * n_temps))


def prior_tables(inbreeding, log_uh, ploidy):
    """The prior's per-problem terms: (tab [S, P + 1], const [S]) such
    that a genotype whose distinct rows have dosages d_i has log prior
    (const - sum_i tab[d_i]) - P log_uh where inbreeding is 0 (flat) and
    const + sum_i tab[d_i] elsewhere (Dirichlet-multinomial), with tab[0]
    = 0.  Computed by the torch operations of ``ops/priors.
    log_genotype_prior_dosage``, term by term."""
    d = torch.arange(ploidy + 1, dtype=_F64, device=inbreeding.device)
    f = inbreeding.to(_F64)
    n = torch.full_like(f, float(ploidy))
    safe_f = torch.where(f > 0, f, 0.5)
    log_disp = torch.log((1.0 - safe_f) / safe_f) - log_uh
    disp = torch.exp(log_disp)[:, None]
    sum_disp = torch.exp(log_disp + log_uh)
    left = torch.lgamma(n + 1.0) + torch.lgamma(sum_disp) - torch.lgamma(n + sum_disp)
    dm = torch.lgamma(d + disp) - (torch.lgamma(d + 1.0) + torch.lgamma(disp.expand(-1, len(d))))
    dm[:, 0] = 0.0
    flat = (f == 0.0)[:, None]
    tab = torch.where(flat, torch.lgamma(d + 1).expand_as(dm), dm)
    const = torch.where(flat[:, 0], torch.lgamma(n + 1), left)
    return tab.contiguous(), const.contiguous()


def _signed64(x):
    x = int(x) & 0xFFFFFFFFFFFFFFFF
    return x - (1 << 64) if x >= 1 << 63 else x


def _launch(seed, row_offset, initial, log_reads, read_counts, n_alleles, break_dist,
            temperatures, *, n_steps, burn, inbreeding, recombination_step_probability,
            partial_dosage_step_probability, dosage_step_probability):
    lib = load_library()
    dev = log_reads.device
    S, C, P, NB = initial.shape
    R, A = log_reads.shape[1], log_reads.shape[3]
    temps = torch.as_tensor(np.asarray(temperatures, float), dtype=_F64, device=dev)
    T = temps.shape[0]
    N, B = S * C, S * C * T
    lr = log_reads.to(_F64).permute(0, 2, 1, 3).contiguous()  # [S, NB, R, A]
    counts = read_counts.to(_F64).contiguous()
    nall = n_alleles.to(torch.int32).contiguous()
    bdist = break_dist.to(_F64).contiguous()
    log_uh = torch.log(n_alleles.to(_F64)).sum(dim=-1)
    init = initial.to(torch.int8).contiguous()
    tab = const = ib = None
    if inbreeding is not None:
        ib = inbreeding.to(_F64).contiguous()
        tab, const = prior_tables(ib, log_uh, P)
    K = P * (P - 1)
    logk = torch.log(torch.arange(K + P + 2, dtype=_F64, device=dev))
    kept = max(n_steps - burn, 0)
    trace_g = torch.empty((kept, N, P, NB), dtype=torch.int8, device=dev)
    trace_llk = torch.empty((kept, N), dtype=_F64, device=dev)

    words = row_words(lib, P, NB)
    n_wi, n_opt, D = words
    piece = rows_per_piece(B, T, row_bytes(P, NB, R, words), dev)
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    state = [empty((piece, P, NB), torch.int8), empty((piece, P, R), _F64),
             empty((piece,), _F64), empty((piece,), torch.int32)]
    work = [empty((piece, D), _F64), empty((piece, P, R), _F64),
            empty((piece, n_opt), _F64), empty((piece, n_wi), torch.int32)]
    tensors = [lr, counts, nall, bdist, log_uh, ib, tab, const, logk, temps, init,
               trace_g, trace_llk, *state, *work]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None or t.numel() == 0 else t.data_ptr() for t in tensors)
    )
    reals = (ctypes.c_double * 4)(
        math.log(P), recombination_step_probability, partial_dosage_step_probability,
        dosage_step_probability,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    for row0 in range(0, B, piece):
        rows = min(piece, B - row0)
        ints = (ctypes.c_int64 * 13)(
            S, C, T, P, NB, R, A, row0, rows, n_steps, burn, _signed64(seed),
            _signed64(row_offset),
        )
        err = lib.denovo_route_run(ctypes.addressof(ptrs), ctypes.addressof(ints),
                                   ctypes.addressof(reals), stream)
        if err != 0:
            msg = lib.denovo_route_error_string(err).decode()
            raise RuntimeError(f"denovo route kernel launch failed: {msg}")
        denovo_route_sampler.launches += 1 + n_steps * (1 + (T > 1))
    genotypes = trace_g.view(kept, S, C, P, NB).permute(1, 2, 0, 3, 4)
    llks = trace_llk.view(kept, S, C).permute(1, 2, 0)
    return genotypes, llks
