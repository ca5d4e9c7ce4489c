"""K2, the calling sampler: CUDA kernel, wrapper and plain version.

Replaces ``mchap_tpu/ops/pallas_calling.py::pallas_calling_sampler``
(body ``_make_kernel``): flat-prior Gibbs over the ploidy slots of each
chain against a fixed haplotype panel.  Every slot starts at allele 0;
each step sweeps the slots in order and draws each from its Gibbs
conditional by Gumbel-max, scoring candidates in the linear domain
against per-read anchors (see ``csrc/calling_sampler.cu``).  The anchor
is the maximum over a problem's valid alleles only, so a read far below
every real haplotype cannot make a padding allele win, as it can in the
TPU kernel.

``calling_sampler`` launches ``csrc/calling_sampler.cu`` on CUDA tensors
(and raises if it cannot) and runs ``calling_sampler_plain``, the same
function in vectorised torch over chains, on CPU tensors.  The plain
version adds in the kernel's order, so with pinned ``noise`` the two
compute the same Markov chain.

Inputs are per problem, not per chain: ``rh`` f32[S, R, H] (read x
haplotype log-probabilities), ``counts`` f32[S, R], ``n_valid`` i32[S]
(columns >= n_valid[s] are padding), and ``problem`` i32[C] maps each
chain to its problem.  Outputs: sorted alleles [n_steps, P, C] (int8, or
int16 when H > 127) and llks f32[n_steps, C].
"""

import ctypes
import math
import threading

import numpy as np
import torch

from mchap_tpu_torch.ops import nvcc_build

_NAME = "calling_sampler"
_WARPS_PER_BLOCK = 4


def allele_dtype(n_alleles):
    return torch.int8 if n_alleles <= 127 else torch.int16


def log_ploidy(ploidy):
    """log P rounded to f32 once, so kernel and plain version share it."""
    return float(np.float32(math.log(ploidy)))


def k2_unsupported_reason(ploidy, n_reads):
    """Why K2 cannot run ``ploidy`` over ``n_reads`` (padded) reads, or
    None when it can: ploidy 1..8, and one chain's (P+3)*R*4 bytes of
    state within a block's shared memory."""
    if not 1 <= ploidy <= 8:
        return f"ploidy {ploidy} outside 1..8"
    need = (ploidy + 3) * n_reads * 4
    if need > nvcc_build.MAX_SMEM:
        return (
            f"{n_reads} reads at ploidy {ploidy} need {need} bytes of shared"
            f" memory ((P+3)*R*4); a block has {nvcc_build.MAX_SMEM}"
        )
    return None


def _check_inputs(rh, counts, n_valid, problem, noise, n_steps, ploidy):
    S, R, H = rh.shape
    C = problem.shape[0]
    expect = [
        ("rh", rh, torch.float32, (S, R, H)),
        ("counts", counts, torch.float32, (S, R)),
        ("n_valid", n_valid, torch.int32, (S,)),
        ("problem", problem, torch.int32, (C,)),
    ]
    if noise is not None:
        expect.append(("noise", noise, torch.float32, (n_steps, ploidy, H, C)))
    for name, t, dtype, shape in expect:
        if t.device != rh.device:
            raise ValueError(f"{name} is on {t.device}, rh on {rh.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= ploidy <= 8:
        raise ValueError(f"ploidy {ploidy} outside 1..8")
    if min(S, R, H) < 1:
        raise ValueError(f"rh must be non-empty, got shape {(S, R, H)}")
    if H > 32767:
        raise ValueError("at most 32767 alleles")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if C and not bool(((problem >= 0) & (problem < S)).all()):
        raise ValueError("problem indices must lie in [0, S)")
    if not bool(((n_valid >= 1) & (n_valid <= H)).all()):
        raise ValueError("n_valid must lie in [1, H]")
    return S, R, H, C


def calling_sampler(rh, counts, n_valid, problem, *, n_steps, ploidy, seed=0,
                    noise=None):
    """Run the calling sampler for C chains; see the module docstring.

    On CUDA tensors this launches the kernel (and raises if it cannot);
    on CPU tensors it runs ``calling_sampler_plain``.  ``noise``
    f32[n_steps, P, H, C] pins every uniform draw (tests); otherwise draws
    come from Philox4x32-10 keyed by (seed, chain) on CUDA and from a
    ``torch.Generator`` seeded with ``seed`` on the CPU.
    """
    _check_inputs(rh, counts, n_valid, problem, noise, n_steps, ploidy)
    kwargs = dict(n_steps=n_steps, ploidy=ploidy, seed=seed, noise=noise)
    if rh.device.type == "cuda":
        return _launch(rh, counts, n_valid, problem, **kwargs)
    if rh.device.type != "cpu":
        raise ValueError(f"unsupported device {rh.device}")
    return calling_sampler_plain(rh, counts, n_valid, problem, **kwargs)


#: kernel launches made through ``calling_sampler`` (CUDA tensors only)
calling_sampler.launches = 0


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build_log_path():
    return nvcc_build.log_path(_NAME)


def load_library():
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = nvcc_build.build_library(_NAME)
        fn = lib.calling_sampler_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 9  # rh counts n_valid problem noise e mlp alleles llks
            + [ctypes.c_int] * 6  # S R H P C n_steps
            + [ctypes.c_float]  # log P
            + [ctypes.c_int]  # out_bytes
            + [ctypes.c_uint64]  # seed
            + [ctypes.c_int]  # warps per block
            + [ctypes.c_void_p]  # stream
        )
        lib.calling_sampler_smem_bytes.restype = ctypes.c_int64
        lib.calling_sampler_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.calling_sampler_error_string.restype = ctypes.c_char_p
        lib.calling_sampler_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def _launch(rh, counts, n_valid, problem, *, n_steps, ploidy, seed, noise):
    S, R, H = rh.shape
    C = problem.shape[0]
    P = ploidy
    lib = load_library()
    reason = k2_unsupported_reason(P, R)
    if reason is not None:
        raise ValueError(reason)
    per_warp = lib.calling_sampler_smem_bytes(P, R)
    warps = max(1, min(_WARPS_PER_BLOCK, nvcc_build.MAX_SMEM // per_warp))
    device = rh.device
    e = torch.empty((S, R, H), dtype=torch.float32, device=device)
    mlp = torch.empty((S, R), dtype=torch.float32, device=device)
    alleles = torch.empty((n_steps, P, C), dtype=allele_dtype(H), device=device)
    llks = torch.empty((n_steps, C), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.calling_sampler_launch(
        rh.data_ptr(), counts.data_ptr(), n_valid.data_ptr(), problem.data_ptr(),
        None if noise is None else noise.data_ptr(), e.data_ptr(), mlp.data_ptr(),
        alleles.data_ptr(), llks.data_ptr(), S, R, H, P, C, n_steps,
        log_ploidy(P), alleles.element_size(), seed & 0xFFFFFFFFFFFFFFFF, warps,
        stream,
    )
    if err != 0:
        msg = lib.calling_sampler_error_string(err).decode()
        raise RuntimeError(f"calling sampler kernel launch failed: {msg}")
    calling_sampler.launches += 1
    return alleles, llks


# ---------------------------------------------------------------------------
# plain PyTorch version (vectorised over chains)
# ---------------------------------------------------------------------------


def calling_sampler_plain(rh, counts, n_valid, problem, *, n_steps, ploidy,
                          seed=0, noise=None):
    """The kernel's Markov chain in vectorised torch (reference version)."""
    S, R, H, C = _check_inputs(rh, counts, n_valid, problem, noise, n_steps, ploidy)
    P = ploidy
    device = rh.device
    alleles_h = torch.arange(H, device=device)
    valid = alleles_h[None, :] < n_valid[:, None]  # [S, H]
    m = torch.where(valid[:, None, :], rh, -math.inf).amax(dim=-1)  # [S, R]
    e = torch.where(valid[:, None, :], torch.exp(rh - m[..., None]), 0.0)
    mlp = m - log_ploidy(P)
    prob = problem.long()
    ec, cntc, mlpc, validc = e[prob], counts[prob], mlp[prob], valid[prob]
    gen = None
    if noise is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

    g = torch.zeros((C, P), dtype=torch.long, device=device)
    es = ec[:, :, 0][:, None, :].repeat(1, P, 1)  # [C, P, R]
    alleles = torch.empty((n_steps, P, C), dtype=allele_dtype(H), device=device)
    llks = torch.empty((n_steps, C), dtype=torch.float32, device=device)
    for step in range(n_steps):
        for k in range(P):
            others = [i for i in range(P) if i != k]
            srest = torch.zeros((C, R), dtype=torch.float32, device=device)
            if others:
                srest = es[:, others[0]]
                for i in others[1:]:
                    srest = srest + es[:, i]
            terms = cntc[:, :, None] * (
                torch.log(srest[:, :, None] + ec) + mlpc[:, :, None]
            )  # [C, R, H]
            l = terms[:, 0]
            for r in range(1, R):  # reads in order, as each kernel lane adds
                l = l + terms[:, r]
            copies = torch.zeros((C, H), dtype=torch.float32, device=device)
            for i in others:
                copies = copies + (g[:, i, None] == alleles_h).float()
            logit = l + torch.log1p(copies)
            if noise is not None:
                u = noise[step, k].T
            else:
                u = torch.rand((C, H), generator=gen, device=device).clamp_(min=1e-12)
            score = torch.where(validc, logit - torch.log(-torch.log(u)), -math.inf)
            choice = torch.argmax(score, dim=1)  # ties: the lowest allele
            g[:, k] = choice
            llk = l.gather(1, choice[:, None])[:, 0]
            es[:, k] = ec.gather(2, choice[:, None, None].expand(C, R, 1))[:, :, 0]
        alleles[step] = torch.sort(g, dim=1).values.T.to(alleles.dtype)
        llks[step] = llk
    return alleles, llks
