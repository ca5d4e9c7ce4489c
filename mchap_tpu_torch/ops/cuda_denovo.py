"""K1, the de novo assembly sampler: CUDA kernel, wrapper and plain version.

Replaces ``mchap_tpu/ops/pallas_denovo.py::pallas_denovo_sampler`` (body
``_make_full_kernel``).  Each chain runs ``n_steps`` compound steps:

1. an MH-within-Gibbs mutation sweep over the P x NB sites in
   systematic h-major order, with the haplotype-copy proposal
   correction (reference assemble/mutation.py:84-139) and an A == 2
   fast path;
2. a fused recombination + partial-dosage sweep over one Bernoulli
   interval partition, capped at ``MAXSEG = max(2, min(NB, NB//4+2))``
   segments (gates ``p_recomb``, ``p_partial``);
3. the full-length dosage step (gate ``p_full``);

with the per-read x haplotype log-likelihoods ``rh`` updated in place
and rebuilt from the genotype every ``refresh`` steps.  Step 2 runs
from ``stage >= 2``, step 3 from ``stage >= 3``; with P == 1 only the
mutation sweep runs.

Two options follow the JAX kernel's ``n_temps`` and ``use_prior`` modes:

- ``temps``, an ascending ladder of T <= 8 inverse temperatures ending
  at 1.0: every chain runs T coupled rungs from the same start, each MH
  log ratio of rung t is multiplied by temps[t], and each step ends with
  neighbour swaps from warm to cold (t = 1..T-1 in turn: swap when
  u < exp(min(0, ((llk + prior)[t-1] - (llk + prior)[t]) *
  (temps[t] - temps[t-1])))).  Only the cold rung's trace is returned.
- ``alpha`` f32[S], the Dirichlet-multinomial dispersion per problem:
  the mutation ratio gains log(count_cur) - log(count_a) +
  log(count_a - 1 + alpha) - log(count_cur - 1 + alpha) and the
  structural ratios prior_S(new) - prior_S(cur), where prior_S sums
  t(d) = sum_{k<d} log(alpha + k) - log d! over the distinct rows of
  dosage d; both inside the temperature factor.

``denovo_sampler`` launches ``csrc/denovo_sampler.cu`` on CUDA tensors
(and raises if it cannot) and runs ``denovo_sampler_plain``, the same
function in vectorised torch over chains, on CPU tensors.  Both consume
the uniform draws of a step in the same order (``draw_layout``), so with
pinned ``noise`` they compute the same Markov chain up to f32 summation
order.

Inputs are per problem, not per chain: ``lr`` f32[S, NB, A, R] (log read
probabilities, reads last), ``counts`` f32[S, R], ``nall`` i32[S, NB]
(1 marks a fixed position), ``pbreak`` f32[S], and ``problem`` i32[C]
maps each chain to its problem.  ``g_init`` is i32[P, NB, C].
Outputs: the base-``next_pow2(A)`` packed trace [n_steps, NB, C]
(uint8/int16/int32 by ``base**P``) and llks f32[n_steps, C].

``mutation_sweep`` (K0, replacing ``pallas_mutation_sweep``) is a second
entry into the same source: step 1 alone, once, at an inverse
temperature, with ``mutation_sweep_plain`` beside it.
"""

import ctypes
import threading

import numpy as np
import torch

from mchap_tpu_torch.ops import nvcc_build
from mchap_tpu_torch.utils.seeds import shard_seed

NEG_BIG = -1e30
MAX_TEMPS = 8
MAX_PLOIDY = 12
_NAME = "denovo_sampler"
_MAX_SMEM = nvcc_build.MAX_SMEM
_WARPS_PER_BLOCK = 4
_TAB = 16  # entries of each of a warp's three f32 tables
_MAX_SLOT = 2 ** 31  # a rung's slot is indexed with 32-bit offsets


def next_pow2(x):
    n = 1
    while n < x:
        n *= 2
    return n


def max_segments(n_base):
    """Cap on interval-partition segments per structural sweep."""
    return max(2, min(n_base, n_base // 4 + 2))


def draw_layout(ploidy, n_base, n_temps=1):
    """Index of each uniform draw within a step, and the step's count D.

    Rung t's draws start at t * rung; within a rung: mutation site
    (h, j) -> h*NB + j; gate_r, gate_d; break before position j
    (1..NB-1); per segment i a recombination and a dosage draw; gate_f;
    the full dosage draw.  The T - 1 swap draws follow the rungs: swap
    t (1..T-1) at swap + t - 1.  With one rung, D == rung.
    """
    P, NB = ploidy, n_base
    maxseg = max_segments(NB)
    brk = P * NB + 2
    seg = brk + NB - 1
    full = seg + 2 * maxseg
    rung = full + 2
    return dict(
        gate_r=P * NB, gate_d=P * NB + 1, brk=brk, seg=seg,
        gate_f=full, full=full + 1, rung=rung, swap=n_temps * rung,
        D=n_temps * rung + n_temps - 1,
    )


def ladder(temps):
    """The inverse-temperature ladder as a tuple of f32-rounded floats;
    ``None`` is the single rung (1.0,)."""
    if temps is None:
        return (1.0,)
    t = torch.as_tensor(temps, dtype=torch.float32).cpu().reshape(-1).tolist()
    if not 1 <= len(t) <= MAX_TEMPS:
        raise ValueError(f"{len(t)} temperatures; K1 runs 1 to {MAX_TEMPS}")
    if t[0] < 0 or any(b < a for a, b in zip(t, t[1:])) or t[-1] != 1.0:
        raise ValueError("temps must ascend from >= 0 to a last rung of 1.0")
    return tuple(t)


def _round16(x):
    return (x + 15) // 16 * 16


def chain_state_layout(ploidy, n_reads, n_base, n_temps=1):
    """Where one chain of ``n_temps`` rungs keeps its state, and its bytes.

    The CPU-side mirror, for the refusal check where no library is
    loaded (the CPU, the CLI's option check), of the kernel's
    ``denovo_sampler_state_layout``, which sets the launch (a CUDA test
    holds the two equal).  A rung's slot: rh and rhi (f32[P][R] each)
    then g (int8[P][NB]); a warp's aux block: three f32 tables of 16
    entries and the segment bounds (int16[NB + 1]); a tempered chain's
    swap state: slot, llk and prior per rung; each in 16-byte units.
    The slots go to shared memory when the whole chain fits one block,
    otherwise to a scratch buffer in device memory.  Returns a dict:
    ``slot`` bytes per rung, ``smem`` and ``scratch`` bytes per chain and
    ``in_smem``.
    """
    P, R, NB, T = ploidy, n_reads, n_base, n_temps
    slot = _round16(8 * P * R + P * NB)
    aux = _round16(4 * 3 * _TAB + 2 * (NB + 1))
    swap = _round16(12 * T) if T > 1 else 0
    every = T * (aux + slot) + swap
    in_smem = every <= _MAX_SMEM
    return dict(
        slot=slot, in_smem=in_smem,
        smem=every if in_smem else T * aux + swap,
        scratch=0 if in_smem else T * slot,
    )


def k1_unsupported_reason(ploidy, n_reads_bucket, n_base, n_temps, inbreeding):
    """Why K1 cannot run this configuration, or None when it can.

    K1 runs ploidy 1..12, at most ``MAX_TEMPS`` rungs, and a
    Dirichlet-multinomial prior only when every sample's inbreeding
    ``inbreeding`` (None for the flat prior) is above 0.  Read depth
    does not limit it: a chain whose state does not fit shared memory
    keeps it in device scratch (``chain_state_layout``), up to a rung of
    2**31 bytes.  ``n_reads_bucket`` None leaves that check out (the
    read count is not known yet).
    """
    if not 1 <= ploidy <= MAX_PLOIDY:
        return f"ploidy {ploidy} outside 1..{MAX_PLOIDY}"
    if n_temps > MAX_TEMPS:
        return f"{n_temps} tempering rungs, more than {MAX_TEMPS}"
    if inbreeding is not None and np.any(np.asarray(inbreeding, float) == 0.0):
        return "a Dirichlet-multinomial prior where some sample has inbreeding 0"
    if n_reads_bucket is not None:
        slot = chain_state_layout(ploidy, n_reads_bucket, n_base, n_temps)["slot"]
        if slot >= _MAX_SLOT:
            return (
                f"a rung of ploidy {ploidy} over {n_reads_bucket} reads needs {slot}"
                f" bytes of state; K1 indexes at most {_MAX_SLOT}"
            )
    return None


def trace_dtype(n_alleles, ploidy):
    """Storage type of the packed trace: values span [0, base**P - 1]."""
    span = next_pow2(max(n_alleles, 2)) ** ploidy
    if span <= 256:
        return torch.uint8
    if span <= 32768:
        return torch.int16
    return torch.int32


def unpack_genotype_trace(packed, ploidy, n_alleles):
    """Decode a packed trace: [n_steps, NB, C] -> int8[n_steps, P, NB, C]."""
    base = next_pow2(max(n_alleles, 2))
    packed = np.asarray(packed, np.int32)
    shifts = np.array([base ** h for h in range(ploidy)], np.int32)
    return (
        (packed[:, None, :, :] // shifts[None, :, None, None]) % base
    ).astype(np.int8)


def _check_inputs(lr, counts, g_init, nall, pbreak, problem, noise, n_steps,
                  temps=(1.0,), alpha=None):
    S, NB, A, R = lr.shape
    P, _, C = g_init.shape
    device = lr.device
    expect = [
        ("lr", lr, torch.float32, (S, NB, A, R)),
        ("counts", counts, torch.float32, (S, R)),
        ("g_init", g_init, torch.int32, (P, NB, C)),
        ("nall", nall, torch.int32, (S, NB)),
        ("pbreak", pbreak, torch.float32, (S,)),
        ("problem", problem, torch.int32, (C,)),
    ]
    if noise is not None:
        D = draw_layout(P, NB, len(temps))["D"]
        expect.append(("noise", noise, torch.float32, (n_steps, D, C)))
    if alpha is not None:
        expect.append(("alpha", alpha, torch.float32, (S,)))
    for name, t, dtype, shape in expect:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, lr on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= P <= MAX_PLOIDY:
        raise ValueError(f"ploidy {P} outside 1..{MAX_PLOIDY}")
    if A < 2:
        raise ValueError("n_alleles must be >= 2")
    if next_pow2(A) ** P >= 2 ** 31:
        raise ValueError("base**ploidy must stay below 2**31 for int32 packing")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    return S, NB, A, R, P, C


def denovo_sampler(lr, counts, g_init, nall, pbreak, problem, *, n_steps,
                   p_recomb=0.5, p_partial=0.5, p_full=1.0, refresh=64,
                   stage=3, seed=0, noise=None, temps=None, alpha=None,
                   chain_offset=0):
    """Run the de novo sampler for C chains; see the module docstring.

    On CUDA tensors this launches the kernel (and raises if it cannot);
    on CPU tensors it runs ``denovo_sampler_plain``.  ``noise``
    f32[n_steps, D, C] (``draw_layout(P, NB, T)["D"]``) pins every
    uniform draw (tests); otherwise draws come from Philox4x32-10 keyed
    by (seed, chain_offset + chain) on CUDA and from a ``torch.Generator``
    seeded with ``shard_seed(seed, chain_offset)`` on the CPU.
    ``chain_offset`` is chain 0's index in the whole block when the
    block is split over launches (``parallel.sharding``).  ``temps``
    (default ``[1.0]``) is the tempering ladder and ``alpha`` f32[S]
    (default None, the flat prior) the Dirichlet-multinomial dispersion
    per problem.
    """
    temps = ladder(temps)
    _check_inputs(lr, counts, g_init, nall, pbreak, problem, noise, n_steps,
                  temps, alpha)
    if stage not in (1, 2, 3):
        raise ValueError(f"stage must be 1, 2 or 3, got {stage}")
    if refresh < 1:
        raise ValueError("refresh must be >= 1")
    kwargs = dict(
        n_steps=n_steps, p_recomb=p_recomb, p_partial=p_partial,
        p_full=p_full, refresh=refresh, stage=stage, seed=seed, noise=noise,
        temps=temps, alpha=alpha,
    )
    if not 0 <= chain_offset < 2 ** 32:
        raise ValueError(f"chain_offset {chain_offset} outside [0, 2**32)")
    if lr.device.type == "cuda":
        return _launch(lr, counts, g_init, nall, pbreak, problem,
                       chain_offset=chain_offset, **kwargs)
    if lr.device.type != "cpu":
        raise ValueError(f"unsupported device {lr.device}")
    kwargs["seed"] = shard_seed(seed, chain_offset)
    return denovo_sampler_plain(
        lr, counts, g_init, nall, pbreak, problem, **kwargs
    )


#: kernel launches made through ``denovo_sampler`` (CUDA tensors only)
denovo_sampler.launches = 0


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_libs = {}
_lib_locks = {False: threading.Lock(), True: threading.Lock()}
_LADDER_NAME = _NAME + "_ladder"


def build_log_path(ladder=False):
    return nvcc_build.log_path(_LADDER_NAME if ladder else _NAME)


def load_library(ladder=False):
    """Build (at first use) and load a shared library of K1.

    ``nvcc`` compiles ``csrc/denovo_sampler.cu`` for sm_90a into
    ``.build/kernels/`` (``nvcc_build``): by default into the library of
    the flat single-rung K1 and of K0, with ``ladder`` (``-DK1_LADDER``)
    into that of K1 with its tempering ladder and prior.  The two builds
    can run at once.  Raises if the build fails.
    """
    with _lib_locks[ladder]:
        if ladder not in _libs:
            _libs[ladder] = _build(ladder)
        return _libs[ladder]


def _build(ladder):
    if ladder:
        lib = nvcc_build.build_library(_LADDER_NAME, _NAME, defines=("K1_LADDER",))
    else:
        lib = nvcc_build.build_library(_NAME)
    fn = lib.denovo_sampler_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 11  # lr counts nall pbreak alpha problem g0 noise trace llks scratch
        + [ctypes.c_int] * 8  # S R NB A P C n_steps T
        + [ctypes.c_void_p]  # temps (host f32[T])
        + [ctypes.c_float] * 3  # p_recomb p_partial p_full
        + [ctypes.c_int] * 3  # refresh stage out_bytes
        + [ctypes.c_uint64]  # seed
        + [ctypes.c_uint32]  # chain_offset
        + [ctypes.c_int]  # warps per block
        + [ctypes.c_void_p]  # stream
    )
    if not ladder:
        fn = lib.mutation_sweep_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 11  # lr counts nall problem g0 noise llk g rh llk scratch
            + [ctypes.c_int] * 6  # S R NB A P C
            + [ctypes.c_float]  # temp
            + [ctypes.c_uint64]  # seed
            + [ctypes.c_int]  # warps per block
            + [ctypes.c_void_p]  # stream
        )
    lib.denovo_sampler_state_layout.restype = ctypes.c_int
    lib.denovo_sampler_state_layout.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int64)] * 2
    )
    lib.denovo_sampler_error_string.restype = ctypes.c_char_p
    lib.denovo_sampler_error_string.argtypes = [ctypes.c_int]
    return lib


def state_layout(lib, P, R, NB, T=1):
    """The kernel's own ``denovo_sampler_state_layout``: a dict like
    ``chain_state_layout``'s (without ``slot``)."""
    smem, scratch = ctypes.c_int64(), ctypes.c_int64()
    in_smem = lib.denovo_sampler_state_layout(
        P, R, NB, T, ctypes.byref(smem), ctypes.byref(scratch)
    )
    return dict(in_smem=bool(in_smem), smem=smem.value, scratch=scratch.value)


def _launch_plan(lib, P, R, NB, T, C, device):
    """Warps per block (whole chains of T rung-warps each, at most
    ``_WARPS_PER_BLOCK`` warps, one chain when T exceeds it, within one
    block's shared memory) and the scratch buffer of C chains (None when
    their state fits shared memory)."""
    reason = k1_unsupported_reason(P, R, NB, T, None)
    if reason is not None:
        raise ValueError(reason)
    lay = state_layout(lib, P, R, NB, T)
    chains = max(1, min(_WARPS_PER_BLOCK // T, _MAX_SMEM // lay["smem"]))
    scratch = None
    if not lay["in_smem"]:
        scratch = torch.empty(C * lay["scratch"], dtype=torch.uint8, device=device)
    return chains * T, scratch


def _launch(lr, counts, g_init, nall, pbreak, problem, *, n_steps, p_recomb,
            p_partial, p_full, refresh, stage, seed, noise, temps, alpha,
            chain_offset=0):
    S, NB, A, R = lr.shape
    P, _, C = g_init.shape
    T = len(temps)
    lib = load_library(ladder=T > 1 or alpha is not None)
    warps, scratch = _launch_plan(lib, P, R, NB, T, C, lr.device)
    dtype = trace_dtype(A, P)
    trace = torch.empty((n_steps, NB, C), dtype=dtype, device=lr.device)
    llks = torch.empty((n_steps, C), dtype=torch.float32, device=lr.device)
    temps_host = (ctypes.c_float * T)(*temps)
    stream = torch.cuda.current_stream(lr.device).cuda_stream
    err = lib.denovo_sampler_launch(
        lr.data_ptr(), counts.data_ptr(), nall.data_ptr(), pbreak.data_ptr(),
        None if alpha is None else alpha.data_ptr(),
        problem.data_ptr(), g_init.data_ptr(),
        None if noise is None else noise.data_ptr(),
        trace.data_ptr(), llks.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        S, R, NB, A, P, C, n_steps, T, ctypes.addressof(temps_host),
        p_recomb, p_partial, p_full, refresh, stage, trace.element_size(),
        seed & 0xFFFFFFFFFFFFFFFF, chain_offset, warps, stream,
    )
    if err != 0:
        msg = lib.denovo_sampler_error_string(err).decode()
        raise RuntimeError(f"denovo sampler kernel launch failed: {msg}")
    denovo_sampler.launches += 1
    return trace, llks


# ---------------------------------------------------------------------------
# plain PyTorch version (vectorised over chains)
# ---------------------------------------------------------------------------


def _option_pairs(ploidy, kind):
    """(a, b) option table: recombination pairs a < b, dosage pairs a != b."""
    P = ploidy
    if kind == 0:
        return [(a, b) for a in range(P) for b in range(a + 1, P)]
    return [(a, b) for a in range(P) for b in range(P) if a != b]


def _read_sum(x):
    """Sum over the trailing read axis in the kernel's order.

    The kernel gives each of a warp's 32 lanes the reads r = lane,
    lane + 32, ..., summed in turn, then adds the lanes in an xor
    butterfly; doing the same here keeps the two versions' MH decisions
    apart only by elementwise rounding, not by summation order.
    """
    R = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (-R) % 32))
    x = x.reshape(x.shape[:-1] + (-1, 32))
    acc = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        acc = acc + x[..., k, :]
    # lane 0 of the butterfly: lane i adds lane i ^ o, which for i < o
    # is lane i + o, and lanes above o hold the same sums (a + b == b + a)
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o : 2 * o]
    return acc[..., 0]


def _seq_cumsum(x):
    """Cumulative sum over the last axis, added left to right."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, dim=-1)


def _lse_rows(rows):
    """logsumexp over a list of [C, R] rows (sequential max and sum)."""
    m = rows[0]
    for o in rows[1:]:
        m = torch.maximum(m, o)
    acc = torch.zeros_like(m)
    for o in rows:
        acc = acc + torch.exp(o - m)
    return m + torch.log(acc)


def _first_of(eq):
    """Label of each row: the first row equal to it.  eq [..., P, P] bool."""
    return eq.to(torch.int8).argmax(dim=-2)


def _prior_table(alpha, ploidy):
    """t(d) = sum_{k<d} log(alpha + k) - log d! for d = 0..P: alpha [C]
    -> [C, P + 1], added and subtracted in the JAX kernel's order."""
    la = [torch.log(alpha + float(k)) for k in range(ploidy)]
    log_m = [torch.log(torch.tensor(float(m))) for m in range(2, ploidy + 1)]
    cols = [torch.zeros_like(alpha)]
    for d in range(1, ploidy + 1):
        s = torch.zeros_like(alpha)
        for k in range(d):
            s = s + la[k]
        for m in range(2, d + 1):
            s = s - log_m[m - 2]
        cols.append(s)
    return torch.stack(cols, dim=-1)


def _prior_sum(eq, tab):
    """Dirichlet-multinomial log prior up to a constant: t(d) of each
    distinct row in row order.  eq [..., P, P] bool full-row equality,
    tab [..., P + 1] -> [...]."""
    P = eq.shape[-1]
    d = eq.sum(dim=-1)  # [..., P] copies of each row
    tab = tab.expand(eq.shape[:-2] + tab.shape[-1:])
    out = torch.zeros(eq.shape[:-2], dtype=torch.float32, device=eq.device)
    for h in range(P):
        first = ~eq[..., :h, h].any(dim=-1)
        t_h = torch.gather(tab, -1, d[..., h : h + 1])[..., 0]
        out = torch.where(first, out + t_h, out)
    return out


def _genotype_prior(g, tab):
    """``_prior_sum`` of each chain's genotype g [C, P, NB]."""
    eq = (g[:, :, None, :] == g[:, None, :, :]).all(dim=-1)
    return _prior_sum(eq, tab)


def _option_terms(li, lo, pairs, kind):
    """Per-option validity from row labels inside (li) and outside (lo) the
    interval: reference recombination_n_options / dosage_n_options.

    li, lo: [..., P] int; returns [..., K] bool.
    """
    P = li.shape[-1]
    eq_in = li[..., :, None] == li[..., None, :]
    eq_full = eq_in & (lo[..., :, None] == lo[..., None, :])
    ar = torch.arange(P, device=li.device)
    first_full = _first_of(eq_full) == ar
    first_in = _first_of(eq_in) == ar
    count_in = eq_in.sum(dim=-2)
    pa = torch.tensor([a for a, _ in pairs], device=li.device)
    pb = torch.tensor([b for _, b in pairs], device=li.device)
    ne_in = ~eq_in[..., pa, pb]
    if kind == 0:
        return first_full[..., pa] & first_full[..., pb] & ne_in & (
            lo[..., pa] != lo[..., pb]
        )
    sd_a = torch.where(first_in[..., pa], count_in[..., pa], 0)
    return first_full[..., pa] & ((sd_a - 1).abs() > 0) & first_in[..., pb] & ne_in


def _structural_mh(g, rh, rh_int, mask, llk, cnt, log_p, gate, u, kind,
                   full_interval, temp, tab=None):
    """One structural MH step over the interval ``mask``.

    g [C, P, NB] long, rh [C, P, R], rh_int [C, P, R] interval sums,
    mask [C, NB] bool, temp [C] inverse temperatures, tab [C, P + 1]
    the prior's t(d) (None: flat prior).  Updates g and rh in place;
    returns (llk, rh_int permuted by the applied move).
    """
    C, P, NB = g.shape
    pairs = _option_pairs(P, kind)
    K = len(pairs)
    len_in = mask.sum(dim=1)  # [C]
    eqpos = g[:, :, None, :] == g[:, None, :, :]  # [C, P, P, NB]
    d_in = (eqpos & mask[:, None, None, :]).sum(dim=-1)
    d_all = eqpos.sum(dim=-1)
    e_in = d_in >= len_in[:, None, None]
    e_out = (d_all - d_in) >= (NB - len_in)[:, None, None]
    lab_in = _first_of(e_in)  # [C, P]
    lab_out = _first_of(e_out)
    valid = _option_terms(lab_in, lab_out, pairs, kind)  # [C, K]
    n_options = valid.sum(dim=1).to(torch.float32)

    # labels after each option, for the reverse-move count n_return
    src = torch.arange(P).repeat(K, 1)  # [K, P] source row of each new row
    for k, (a, b) in enumerate(pairs):
        src[k, a] = b
        if kind == 0:
            src[k, b] = a
    src = src.to(g.device)
    li_k = lab_in[:, src]  # [C, K, P]
    lo_k = lab_out[:, None, :].expand(C, K, P)
    n_return = _option_terms(li_k, lo_k, pairs, kind).sum(dim=-1)  # [C, K]

    # shared-anchor scoring: every excluded-row sum is built by adding
    # the kept rows' exp(row - anchor) in row order, as the kernel does
    pa = torch.tensor([a for a, _ in pairs], device=g.device)
    pb = torch.tensor([b for _, b in pairs], device=g.device)
    ar = torch.arange(P, device=g.device)
    kept = ar != pa[:, None]  # [K, P]
    if kind == 0:
        kept = kept & (ar != pb[:, None])
    m_anchor = rh.max(dim=1).values[:, None]  # [C, 1, R]
    e_rows = torch.exp(rh - m_anchor)  # [C, P, R]
    se = torch.zeros((C, K, rh.shape[-1]), dtype=torch.float32, device=g.device)
    for h in range(P):
        se = torch.where(kept[None, :, h, None], se + e_rows[:, h, None], se)

    def log_of(e_sum):
        return torch.log(torch.clamp(e_sum, min=1e-30)) + m_anchor

    if kind == 0:
        row_a = rh[:, pa] - rh_int[:, pa] + rh_int[:, pb]
        row_b = rh[:, pb] - rh_int[:, pb] + rh_int[:, pa]
        cand = torch.logaddexp(torch.logaddexp(row_a, row_b), log_of(se))
    elif full_interval:
        cand = log_of(se + e_rows[:, pb])
    else:
        row_a = rh[:, pa] - rh_int[:, pa] + rh_int[:, pb]
        cand = torch.logaddexp(row_a, log_of(se))
    llk_opts = _read_sum(cnt[:, None] * (cand - log_p))  # [C, K]

    n_opt1 = torch.clamp(n_options, min=1.0)[:, None]
    lp = torch.log(n_opt1) - torch.log(torch.clamp(n_return.float(), min=1.0))
    dl = llk_opts - llk[:, None]
    if tab is not None:
        # full-row equality after each option: row i of the new genotype
        # is row src[k, i] inside the interval and row i outside it
        s_cur = _prior_sum(e_in & e_out, tab)
        new_eq = e_in[:, src[:, :, None], src[:, None, :]] & e_out[:, None]
        dl = dl + (_prior_sum(new_eq, tab[:, None]) - s_cur[:, None])
    mh = dl * temp[:, None] + lp
    probs = torch.where(
        valid & gate[:, None],
        torch.exp(torch.clamp(mh, max=0.0)) / n_opt1,
        torch.zeros((), dtype=torch.float32, device=g.device),
    )
    cdf = _seq_cumsum(probs)
    chosen = (cdf <= u[:, None]).sum(dim=1).clamp(max=K - 1)
    moved = u < cdf[:, -1]

    ident = torch.arange(P, device=g.device).expand(C, P)
    row_src = torch.where(moved[:, None], src[chosen], ident)  # [C, P]
    changed = row_src != ident
    g_src = torch.gather(g, 1, row_src[:, :, None].expand(C, P, NB))
    g.copy_(torch.where(mask[:, None, :], g_src, g))
    rh_int_new = torch.gather(
        rh_int, 1, row_src[:, :, None].expand_as(rh_int)
    )
    rh.copy_(torch.where(changed[:, :, None], rh - rh_int + rh_int_new, rh))
    llk = torch.where(moved, llk_opts.gather(1, chosen[:, None])[:, 0], llk)
    return llk, rh_int_new


def _row_sums(g, lrc, mask=None):
    """Sum over positions (in order) of lr at each row's allele,
    restricted to ``mask`` [C, NB]: g [C, P, NB], lrc [C, NB, A, R] ->
    [C, P, R]."""
    C, P, NB = g.shape
    A, R = lrc.shape[2:]
    idx = g[:, :, :, None, None].expand(C, P, NB, 1, R)
    src = lrc[:, None].expand(C, P, NB, A, R)
    sel = torch.gather(src, 3, idx)[:, :, :, 0, :]  # [C, P, NB, R]
    acc = torch.zeros((C, P, R), dtype=torch.float32, device=g.device)
    for j in range(NB):
        if mask is None:
            acc = acc + sel[:, :, j]
        else:
            acc = torch.where(mask[:, j, None, None], acc + sel[:, :, j], acc)
    return acc


def _sel1(lr_j, val):
    """lr_j [C, A, R] at allele val [C] -> [C, R]."""
    C, _, R = lr_j.shape
    return torch.gather(lr_j, 1, val[:, None, None].expand(C, 1, R))[:, 0]


def _mutation_sweep_plain(g, rh, llk, lrc, cnt, nallc, uni, log_p, temp=1.0,
                          alpha=None):
    """One MH mutation sweep of every chain in systematic h-major site
    order, at inverse temperature ``temp`` (a number or f32[C]).

    g [C, P, NB] long and rh [C, P, R] are updated in place; uni holds
    site (h, j)'s draw in row h * NB + j.  ``alpha`` f32[C] adds the
    Dirichlet-multinomial prior ratio.  Returns the new llk [C].
    """
    C, P, NB = g.shape
    A, R = lrc.shape[2:]
    device = g.device
    zero = torch.zeros((), dtype=torch.float32, device=device)
    ar_p = torch.arange(P, device=device)
    ar_a = torch.arange(A, device=device)
    temp_a = temp[:, None] if torch.is_tensor(temp) else temp
    alpha_a = None if alpha is None else alpha[:, None]
    for h in range(P):
        others = [rh[:, i] for i in range(P) if i != h]
        if others:
            rest = _lse_rows(others)
        else:
            rest = torch.full((C, R), NEG_BIG, device=device)
        d = (g == g[:, h : h + 1]).sum(dim=2)  # [C, P] row matches
        other = ar_p != h
        for j in range(NB):
            cur = g[:, h, j]
            lr_j = lrc[:, j]  # [C, A, R]
            lr_cur = _sel1(lr_j, cur)
            b = rh[:, h] - lr_cur
            nall_j = nallc[:, j]
            colv = g[:, :, j]  # [C, P]
            eqj = colv == cur[:, None]
            eq_ex = ((d - eqj.long()) >= NB - 1) & other
            u = uni[h * NB + j]
            if A == 2:
                alt = 1 - cur
                lr_alt = _sel1(lr_j, alt)
                cand = torch.logaddexp(rest, b + lr_alt)
                llk_alt = _read_sum(cnt * (cand - log_p))
                count_cur = 1.0 + (eq_ex & eqj).sum(dim=1).float()
                count_alt = 1.0 + (eq_ex & ~eqj).sum(dim=1).float()
                dl = llk_alt - llk
                if alpha is not None:
                    dl = dl + (
                        torch.log(count_cur) - torch.log(count_alt)
                        + torch.log(count_alt - 1.0 + alpha)
                        - torch.log(count_cur - 1.0 + alpha)
                    )
                mh = dl * temp + torch.log(count_alt) - torch.log(count_cur)
                p_acc = torch.where(
                    nall_j > 1, torch.exp(torch.clamp(mh, max=0.0)), zero
                )
                moved = u < p_acc
                new = torch.where(moved, alt, cur)
                lr_new = lr_alt
                llk = torch.where(moved, llk_alt, llk)
            else:
                cand = torch.logaddexp(rest[:, None], b[:, None] + lr_j)
                llk_a = _read_sum(cnt[:, None] * (cand - log_p))  # [C, A]
                counts_a = 1.0 + (
                    eq_ex[:, :, None] & (colv[:, :, None] == ar_a)
                ).sum(dim=1).float()  # [C, A]
                count_cur = counts_a.gather(1, cur[:, None])[:, 0]
                valid = (
                    (ar_a < nall_j[:, None])
                    & (ar_a != cur[:, None])
                    & (nall_j[:, None] > 1)
                )
                n_opt = torch.clamp(valid.sum(dim=1).float(), min=1.0)
                dl = llk_a - llk[:, None]
                if alpha is not None:
                    dl = dl + (
                        torch.log(count_cur)[:, None] - torch.log(counts_a)
                        + torch.log(counts_a - 1.0 + alpha_a)
                        - torch.log(count_cur - 1.0 + alpha)[:, None]
                    )
                mh = dl * temp_a + torch.log(counts_a) - torch.log(count_cur)[:, None]
                probs = torch.where(
                    valid, torch.exp(torch.clamp(mh, max=0.0)) / n_opt[:, None],
                    zero,
                )
                cdf = _seq_cumsum(probs)
                chosen = (cdf <= u[:, None]).sum(dim=1).clamp(max=A - 1)
                moved = u < cdf[:, -1]
                new = torch.where(moved, chosen, cur)
                lr_new = _sel1(lr_j, new)
                llk = torch.where(moved, llk_a.gather(1, chosen[:, None])[:, 0], llk)
            rh[:, h] = torch.where(moved[:, None], b + lr_new, rh[:, h])
            d = d + (moved[:, None] & other) * (
                (colv == new[:, None]).long() - eqj.long()
            )
            g[:, h, j] = new
    return llk


def denovo_sampler_plain(lr, counts, g_init, nall, pbreak, problem, *,
                         n_steps, p_recomb=0.5, p_partial=0.5, p_full=1.0,
                         refresh=64, stage=3, seed=0, noise=None, temps=None,
                         alpha=None):
    """The kernel's Markov chain in vectorised torch (reference version).

    Chain c's rung t is row c * T + t of the state; every rung starts
    from the chain's ``g_init``.
    """
    temps = ladder(temps)
    S, NB, A, R, P, C = _check_inputs(
        lr, counts, g_init, nall, pbreak, problem, noise, n_steps, temps, alpha
    )
    T = len(temps)
    device = lr.device
    lay = draw_layout(P, NB, T)
    maxseg = max_segments(NB)
    base = next_pow2(A)
    gen = None
    if noise is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    prob = problem.long().repeat_interleave(T)
    CT = C * T
    lrc = lr[prob]  # [CT, NB, A, R]
    cnt = counts[prob]  # [CT, R]
    nallc = nall[prob]  # [CT, NB]
    pbc = pbreak[prob]  # [CT]
    ladder_t = torch.tensor(temps, dtype=torch.float32, device=device)
    temp = ladder_t.repeat(C)  # [CT]
    alpha_c = None if alpha is None else alpha[prob]
    tab = None if alpha is None else _prior_table(alpha_c, P)
    log_p = torch.log(torch.tensor(float(P), dtype=torch.float32))
    g = g_init.permute(2, 0, 1).long().repeat_interleave(T, dim=0).contiguous()
    rh = torch.zeros((CT, P, R), dtype=torch.float32, device=device)
    llk = torch.zeros(CT, dtype=torch.float32, device=device)
    trace = torch.empty((n_steps, NB, C), dtype=trace_dtype(A, P), device=device)
    llks = torch.empty((n_steps, C), dtype=torch.float32, device=device)
    weights = torch.tensor([base ** h for h in range(P)], device=device)
    rows = torch.arange(C, device=device)[:, None] * T

    for step in range(n_steps):
        if noise is not None:
            uni_step = noise[step]  # [D, C]
        else:
            uni_step = torch.rand(
                (lay["D"], C), generator=gen, device=device
            ).clamp_(min=1e-12)
        # rung t of chain c draws from rows t * rung.. of column c
        uni = uni_step[: lay["swap"]].reshape(T, lay["rung"], C)
        uni = uni.permute(1, 2, 0).reshape(lay["rung"], CT)

        if step % refresh == 0:
            rh = _row_sums(g, lrc)
            llk = _read_sum(cnt * (_lse_rows([rh[:, h] for h in range(P)]) - log_p))

        # 1. mutation sweep, systematic h-major site order
        llk = _mutation_sweep_plain(
            g, rh, llk, lrc, cnt, nallc, uni, log_p, temp, alpha_c
        )

        # 2. fused recombination + partial-dosage sweep
        if stage >= 2 and P > 1:
            gate_r = uni[lay["gate_r"]] <= p_recomb
            gate_d = uni[lay["gate_d"]] <= p_partial
            seg = torch.zeros((CT, NB), dtype=torch.long, device=device)
            acc = torch.zeros(CT, dtype=torch.long, device=device)
            for j in range(1, NB):
                brk = uni[lay["brk"] + j - 1] < pbc
                acc = torch.clamp(acc + brk.long(), max=maxseg - 1)
                seg[:, j] = acc
            for i in range(maxseg):
                mask = seg == i
                rh_int = _row_sums(g, lrc, mask)
                llk, rh_int = _structural_mh(
                    g, rh, rh_int, mask, llk, cnt, log_p, gate_r,
                    uni[lay["seg"] + 2 * i], 0, False, temp, tab,
                )
                if stage >= 3:
                    llk, _ = _structural_mh(
                        g, rh, rh_int, mask, llk, cnt, log_p, gate_d,
                        uni[lay["seg"] + 2 * i + 1], 1, False, temp, tab,
                    )

        # 3. full-length dosage step: the interval sums are the rh rows
        if stage >= 3 and P > 1:
            gate_f = uni[lay["gate_f"]] <= p_full
            mask = torch.ones((CT, NB), dtype=torch.bool, device=device)
            llk, _ = _structural_mh(
                g, rh, rh.clone(), mask, llk, cnt, log_p, gate_f,
                uni[lay["full"]], 1, True, temp, tab,
            )

        # 4. neighbour swaps from warm to cold: each exchanges the two
        # rungs' state (g, rh, llk and prior) by a permutation of rows
        if T > 1:
            llk_r = llk.view(C, T).clone()
            if tab is None:
                pri_r = torch.zeros_like(llk_r)
            else:
                pri_r = _genotype_prior(g, tab).view(C, T)
            order = torch.arange(T, device=device).repeat(C, 1)
            for t in range(1, T):
                u = uni_step[lay["swap"] + t - 1]
                ex = ((llk_r[:, t - 1] + pri_r[:, t - 1]) - (llk_r[:, t] + pri_r[:, t])) * (
                    ladder_t[t] - ladder_t[t - 1]
                )
                sw = u < torch.exp(torch.clamp(ex, max=0.0))
                for x in (llk_r, pri_r, order):
                    a, b = x[:, t - 1].clone(), x[:, t].clone()
                    x[:, t - 1] = torch.where(sw, b, a)
                    x[:, t] = torch.where(sw, a, b)
            idx = (rows + order).reshape(-1)
            g, rh, llk = g[idx], rh[idx], llk_r.reshape(-1)

        cold = g.view(C, T, P, NB)[:, T - 1]
        trace[step] = (cold * weights[None, :, None]).sum(dim=1).T.to(trace.dtype)
        llks[step] = llk.view(C, T)[:, T - 1]
    return trace, llks



# ---------------------------------------------------------------------------
# K0: one mutation sweep (second entry of the same CUDA source)
# ---------------------------------------------------------------------------


def _mutation_layout(n_alleles, lr, counts, g_onehot, llk, noise):
    """Check K0's inputs (JAX layout, chains last) and recast them as K1's
    per-problem layout with one problem per chain."""
    R, NB, A, C = lr.shape
    P = g_onehot.shape[0]
    expect = [
        ("n_alleles", n_alleles, torch.int32, (NB,)),
        ("counts", counts, torch.float32, (R, C)),
        ("g_onehot", g_onehot, torch.float32, (P, NB, A, C)),
        ("llk", llk, torch.float32, (C,)),
    ]
    if noise is not None:
        expect.append(("noise", noise, torch.float32, (P * NB, C)))
    if lr.dtype != torch.float32:
        raise ValueError(f"lr must be torch.float32, got {lr.dtype}")
    for name, t, dtype, shape in expect:
        if t.device != lr.device:
            raise ValueError(f"{name} is on {t.device}, lr on {lr.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not 1 <= P <= 8:
        raise ValueError(f"ploidy {P} outside 1..8")
    if A < 2:
        raise ValueError("n_alleles must be >= 2")
    return dict(
        lr=lr.permute(3, 1, 2, 0).contiguous(),  # [C, NB, A, R]
        counts=counts.T.contiguous(),  # [C, R]
        nall=n_alleles[None].expand(C, NB).contiguous(),
        problem=torch.arange(C, dtype=torch.int32, device=lr.device),
        g=g_onehot.argmax(dim=2).to(torch.int32).contiguous(),  # [P, NB, C]
        llk=llk.contiguous(),
        noise=None if noise is None else noise.contiguous(),
    )


def _as_onehot(g, n_alleles):
    """int genotypes [P, NB, C] -> f32 one-hot [P, NB, A, C]."""
    onehot = torch.nn.functional.one_hot(g.long(), n_alleles)  # [P, NB, C, A]
    return onehot.permute(0, 1, 3, 2).to(torch.float32).contiguous()


def mutation_sweep(seed, n_alleles, lr, counts, g_onehot, llk, temp, *, noise=None):
    """K0: one MH mutation sweep for many chains at inverse temperature
    ``temp``, starting from the given ``llk``.

    The argument list and layout are those of
    ``mchap_tpu/ops/pallas_denovo.py::pallas_mutation_sweep``:
    ``n_alleles`` i32[NB], ``lr`` f32[R, NB, A, C] (log read
    probabilities, chains last), ``counts`` f32[R, C], ``g_onehot``
    f32[P, NB, A, C], ``llk`` f32[C].  ``rh`` is rebuilt from the
    genotype, then the P x NB sites are swept in h-major order with one
    uniform each: ``noise`` f32[P * NB, C] pins them (tests), otherwise
    they come from Philox keyed by (seed, chain) on CUDA and from a
    ``torch.Generator`` on the CPU.  Returns (g_onehot', rh' f32[P, R,
    C], llk' f32[C]).  CUDA tensors launch the kernel (or raise); CPU
    tensors run ``mutation_sweep_plain``.
    """
    if lr.device.type == "cuda":
        return _launch_mutation(
            seed, n_alleles, lr, counts, g_onehot, llk, temp, noise=noise
        )
    if lr.device.type != "cpu":
        raise ValueError(f"unsupported device {lr.device}")
    return mutation_sweep_plain(
        seed, n_alleles, lr, counts, g_onehot, llk, temp, noise=noise
    )


#: kernel launches made through ``mutation_sweep`` (CUDA tensors only)
mutation_sweep.launches = 0


def _launch_mutation(seed, n_alleles, lr, counts, g_onehot, llk, temp, *, noise):
    R, NB, A, C = lr.shape
    P = g_onehot.shape[0]
    x = _mutation_layout(n_alleles, lr, counts, g_onehot, llk, noise)
    lib = load_library()
    warps, scratch = _launch_plan(lib, P, R, NB, 1, C, lr.device)
    g_out = torch.empty_like(x["g"])
    rh = torch.empty((P, R, C), dtype=torch.float32, device=lr.device)
    llk_out = torch.empty(C, dtype=torch.float32, device=lr.device)
    stream = torch.cuda.current_stream(lr.device).cuda_stream
    err = lib.mutation_sweep_launch(
        x["lr"].data_ptr(), x["counts"].data_ptr(), x["nall"].data_ptr(),
        x["problem"].data_ptr(), x["g"].data_ptr(),
        None if noise is None else x["noise"].data_ptr(), x["llk"].data_ptr(),
        g_out.data_ptr(), rh.data_ptr(), llk_out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        C, R, NB, A, P, C, float(temp), int(seed) & 0xFFFFFFFFFFFFFFFF, warps,
        stream,
    )
    if err != 0:
        msg = lib.denovo_sampler_error_string(err).decode()
        raise RuntimeError(f"mutation sweep kernel launch failed: {msg}")
    mutation_sweep.launches += 1
    return _as_onehot(g_out, A), rh, llk_out


def mutation_sweep_plain(seed, n_alleles, lr, counts, g_onehot, llk, temp, *,
                         noise=None):
    """K0's sweep in vectorised torch (reference version)."""
    R, NB, A, C = lr.shape
    P = g_onehot.shape[0]
    x = _mutation_layout(n_alleles, lr, counts, g_onehot, llk, noise)
    uni = x["noise"]
    if uni is None:
        gen = torch.Generator(device=lr.device)
        gen.manual_seed(int(seed))
        uni = torch.rand((P * NB, C), generator=gen, device=lr.device).clamp_(min=1e-12)
    g = x["g"].permute(2, 0, 1).long().contiguous()  # [C, P, NB]
    rh = _row_sums(g, x["lr"])
    log_p = torch.log(torch.tensor(float(P), dtype=torch.float32))
    llk = _mutation_sweep_plain(
        g, rh, x["llk"].clone(), x["lr"], x["counts"], x["nall"], uni, log_p,
        float(temp),
    )
    return _as_onehot(g.permute(1, 2, 0), A), rh.permute(1, 2, 0).contiguous(), llk
