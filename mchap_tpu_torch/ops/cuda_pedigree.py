"""K3, the pedigree Gibbs sampler: CUDA kernel, wrapper and plain version.

Replaces ``mchap_tpu/ops/pallas_pedigree.py::pallas_pedigree_sampler``
(body ``_make_kernel``, static plan ``_Plan``).  One compound step, per
(locus, chain):

- every sample is updated in the JAX kernel's order (``update_order``:
  samples grouped by their static trio configuration, groups ordered by
  their first member, members ascending), its slots 0..P-1 in turn, each
  drawn from its Gibbs conditional over every candidate allele h by
  Gumbel-max (ties to the lower allele):
    logit[h] = llk[h] + log trio(sample) + sum over children of log
               trio(child) + log1p(copies of h among the other slots);
  columns h >= n_valid are never drawn;
- then each parental pair (p, q), p != q, does one Metropolis-Hastings
  allele swap with the full Markov-blanket ratio (reference
  mcmc.py:503-655).

Numbers.  A read's candidate term is the exact log-mixture
``logaddexp(rest[r], rh[r, h])`` in f32, where ``rest`` is the
log-sum-exp of the other slots: no read underflows, however far below
the current haplotypes it lies (the TPU kernel floors ``exp`` sums at
1e-30, which mis-scores a read about 69 nats below its best haplotype).
The terms are accumulated over reads in f64.  The trio pmf (lambda 0) is
the four-branch error mixture A/B/C/D of the reference (prior.py:484-722)
in f64 linear space over the gamete compositions each parental dosage
allows, then logged (0 -> ``NEG``).  The H100 runs f64 at half its f32
rate, and the trio arithmetic is small next to the read terms, so f64
costs little and keeps the prior as exact as the reference's.

Faults of the TPU kernel that are not copied: a sample's own dose is
read live with the candidate in place wherever it appears (so a selfed
child, parents (s, s), sees the candidate on both sides); a pair blanket
counts each member once (in a backcross the pair member that is also a
child is not counted twice); a pair (p, p) is skipped, as its swap is a
no-op on the genotype multiset.

``pedigree_sampler`` launches ``csrc/pedigree_sampler.cu`` on CUDA
tensors (and raises if it cannot) and runs ``pedigree_sampler_plain``,
the same function in vectorised torch over chains, on CPU tensors.

The kernel runs one block of ``warps_per_block`` warps per (locus,
chain), the chain's genotypes in shared memory.  ``Plan.waves`` cuts the
update order into runs of consecutive samples none of which is in
another's Markov blanket (parents, children, the children's other
parents).  A wave's members are updated at once, in rounds of up to one
per warp, each on a team of warps (a lone founder on the whole block, a
family's progeny on one warp each).  Their conditionals read disjoint
state and every draw is addressed by (step, sample, slot, candidate), so
the trace is the serial order's.  Within a team the read terms are
spread over (read, candidate) and a founder's trios over (child,
candidate), then added per candidate in the plain version's order.

Inputs are per problem: ``rh`` f32[N, S, R, H] (read x haplotype
log-probabilities), ``counts`` f32[N, S, R], ``freqs`` f64[N, H] (linear
prior frequencies), ``n_valid`` i32[N]; ``problem`` i32[C] maps each
chain to its problem and ``initial`` i32[C, S, maxp] holds each chain's
start (-1 pads the slots of lower-ploidy samples).  Output: the raw slot
alleles after each step, int16[C, n_steps, S, maxp].
"""

import ctypes
import math
import threading

import numpy as np
import torch

from mchap_tpu_torch.ops import nvcc_build
from mchap_tpu_torch.ops.pedigree_mcmc import markov_blankets
from mchap_tpu_torch.utils.philox import philox4x32_10, split_seed, uniform_f32

_NAME = "pedigree_sampler"
MAX_PLOIDY = 8
NEG = -1e300
# log P (0 for P = 0) and log1p(copies), for 0..8, shared by the kernel
# and the plain version
_LOG_PLOIDY = np.array([0.0] + [math.log(P) for P in range(1, MAX_PLOIDY + 1)])
_LOG1P = np.log1p(np.arange(MAX_PLOIDY + 1, dtype=np.float64))


class UnsupportedPedigree(ValueError):
    """Pedigree configuration outside K3's support."""


def k3_unsupported_reason(sample_ploidy, sample_parents, gamete_tau,
                          gamete_lambda, step_type="Gibbs"):
    """Why K3 cannot run this configuration, or None when it can.

    K3 runs Gibbs steps without double reduction (every lambda 0) where
    every present parent's gamete ploidy lies in [0, ploidy] and every
    two-parent sample's gamete ploidies sum to its ploidy.
    """
    ploidy = np.asarray(sample_ploidy, int)
    parents = np.asarray(sample_parents, int)
    tau = np.asarray(gamete_tau, int)
    if step_type != "Gibbs":
        return f"step type {step_type}"
    if np.any(np.asarray(gamete_lambda, float) != 0.0):
        return "gamete_lambda != 0 (double reduction)"
    if ploidy.min() < 1 or ploidy.max() > MAX_PLOIDY:
        return f"ploidy outside 1..{MAX_PLOIDY}"
    for i in range(len(ploidy)):
        p, q = parents[i]
        for j, r in enumerate((p, q)):
            if r >= 0 and not 0 <= tau[i, j] <= ploidy[i]:
                return f"gamete ploidy outside [0, ploidy] for sample {i}"
        if p >= 0 and q >= 0 and tau[i, 0] + tau[i, 1] != ploidy[i]:
            return f"gamete ploidies do not sum to the ploidy of sample {i}"
    return None


def update_order(sample_ploidy, sample_parents, gamete_tau, gamete_error):
    """Sample update order of the JAX kernel's ``_Plan``
    (pallas_pedigree.py:164-220): samples grouped by (own trio
    configuration, set of child-edge classes), groups sorted by their
    first member, members ascending."""
    ploidy = np.asarray(sample_ploidy, int)
    parents = np.asarray(sample_parents, int)
    tau = np.asarray(gamete_tau, int)
    err = np.asarray(gamete_error, float)
    n = len(ploidy)

    def cfg(i):
        p, q = int(parents[i, 0]), int(parents[i, 1])
        return (
            int(ploidy[i]), p >= 0, q >= 0, int(tau[i, 0]), int(tau[i, 1]),
            float(err[i, 0]) if p >= 0 else 1.0,
            float(err[i, 1]) if q >= 0 else 1.0,
            int(ploidy[p]) if p >= 0 else 0, int(ploidy[q]) if q >= 0 else 0,
        )

    children = [[] for _ in range(n)]
    for i in range(n):
        seen = set()
        for side in range(2):
            r = int(parents[i, side])
            if r >= 0 and r not in seen:
                children[r].append((side, cfg(i)))
                seen.add(r)
    groups = {}
    for i in range(n):
        key = (cfg(i), tuple(sorted(set(children[i]))))
        groups.setdefault(key, []).append(i)
    return [m for members in sorted(groups.values(), key=lambda ms: ms[0])
            for m in sorted(members)]


def trio_weights(P, has_p, has_q, tau_p, tau_q, err_p, err_q, ploidy_p, ploidy_q):
    """Branch weights (A, B, C, D) of the linear trio pmf of a sample of
    ploidy P.  A missing parent, and a clone edge (tau 0), put its side
    in error (err 1), as ``trio_log_pmf`` does."""
    ep = err_p if has_p and tau_p > 0 else 1.0
    eq = err_q if has_q and tau_q > 0 else 1.0
    use_p, use_q = ep < 1.0, eq < 1.0
    cp = max(math.comb(ploidy_p, tau_p), 1) if use_p else 1
    cq = max(math.comb(ploidy_q, tau_q), 1) if use_q else 1
    wa = (1.0 - ep) * (1.0 - eq) / (cp * cq) if use_p and use_q else 0.0
    wb = (1.0 - ep) * eq * math.factorial(P - tau_p) / cp if use_p and eq > 0 else 0.0
    wc = ep * (1.0 - eq) * math.factorial(P - tau_q) / cq if use_q and ep > 0 else 0.0
    wd = math.factorial(P) * ep * eq if ep > 0 and eq > 0 else 0.0
    return wa, wb, wc, wd


class Plan:
    """Static tables of one pedigree for K3 and its plain version.

    ``order`` (sample update order), per sample its ploidy, parents,
    gamete ploidies and trio branch weights, each sample's children (each
    child once, ascending), and the parental pairs (p < q, first-seen
    order, p == q skipped) with their blankets (the pair and the
    children of either parent, each once, ascending), and ``waves``:
    ``order`` cut greedily into maximal runs of consecutive samples none
    of which is in another's Markov blanket.
    """

    def __init__(self, sample_ploidy, sample_parents, gamete_tau,
                 gamete_lambda, gamete_error, swap_parental_alleles=True):
        reason = k3_unsupported_reason(
            sample_ploidy, sample_parents, gamete_tau, gamete_lambda
        )
        if reason is not None:
            raise UnsupportedPedigree(reason)
        self.ploidy = np.asarray(sample_ploidy, np.int64)
        self.parents = np.asarray(sample_parents, np.int64)
        self.tau = np.asarray(gamete_tau, np.int64)
        err = np.asarray(gamete_error, float)
        n = self.n_samples = len(self.ploidy)
        if np.any(self.parents >= n) or np.any(self.parents == np.arange(n)[:, None]):
            raise ValueError("a parent index is out of range or the sample itself")
        self.max_ploidy = int(self.ploidy.max())
        self.order = update_order(self.ploidy, self.parents, self.tau, err)
        has = self.parents >= 0
        self.tau = np.where(has, self.tau, 0)
        pl = np.where(has, self.ploidy[self.parents.clip(0)], 0)
        self.weights = np.array([
            trio_weights(int(self.ploidy[i]), has[i, 0], has[i, 1], int(self.tau[i, 0]),
                         int(self.tau[i, 1]), float(err[i, 0]), float(err[i, 1]),
                         int(pl[i, 0]), int(pl[i, 1]))
            for i in range(n)
        ])
        self.children = [[] for _ in range(n)]
        for i in range(n):
            for r in sorted({int(r) for r in self.parents[i] if r >= 0}):
                self.children[r].append(i)
        self.pairs, self.blankets = [], []
        if swap_parental_alleles:
            seen = set()
            for i in range(n):
                p, q = sorted(int(r) for r in self.parents[i])
                if p < 0 or p == q or (p, q) in seen:
                    continue
                seen.add((p, q))
                self.pairs.append((p, q))
                self.blankets.append(sorted({p, q, *self.children[p], *self.children[q]}))
        blanket = markov_blankets(self.parents)
        self.waves = []
        for s in self.order:
            if self.waves and not any(s in blanket[m] for m in self.waves[-1]):
                self.waves[-1].append(s)
            else:
                self.waves.append([s])
        # the plain version evaluates samples of one trio configuration
        # (parents, gamete ploidies, weights, ploidy) as one batch
        self.child_groups = [self._groups(c) for c in self.children]
        self.blanket_groups = [self._groups(b) for b in self.blankets]

    def _groups(self, ids):
        out = {}
        for x in ids:
            key = (tuple(self.parents[x]), tuple(self.tau[x]),
                   tuple(self.weights[x]), int(self.ploidy[x]))
            out.setdefault(key, []).append(x)
        return list(out.values())

    def ints(self):
        """Every int table in one i32 array, and the offsets (see
        ``csrc/pedigree_sampler.cu``, struct Plan)."""
        n = self.n_samples
        child_ptr = np.cumsum([0] + [len(c) for c in self.children])
        blanket_ptr = np.cumsum([0] + [len(b) for b in self.blankets])
        wave_ptr = np.cumsum([0] + [len(w) for w in self.waves])
        parts = [
            self.order, self.ploidy, self.parents.ravel(), self.tau.ravel(),
            child_ptr, [c for cs in self.children for c in cs],
            [x for pq in self.pairs for x in pq], blanket_ptr,
            [m for b in self.blankets for m in b], wave_ptr,
        ]
        offsets = np.cumsum([0] + [len(x) for x in parts])[:-1]
        flat = np.concatenate([np.asarray(x, np.int64) for x in parts] + [np.zeros(1, np.int64)])
        assert len(flat) < 2 ** 31 and n < 2 ** 15
        return flat.astype(np.int32), [int(o) for o in offsets]

    def device_tables(self, device):
        """(int table, f64 weights then log P and log1p(P) for P = 0..8,
        offsets) on ``device``, as the kernel reads them."""
        flat, offsets = self.ints()
        weights = np.concatenate([self.weights.ravel(), _LOG_PLOIDY, _LOG1P])
        return (
            torch.as_tensor(flat, device=device),
            torch.as_tensor(weights, dtype=torch.float64, device=device),
            offsets,
        )

    def n_draws(self, n_alleles):
        """Uniform draws per step: one per (sample, slot, candidate), then
        three per pair (p's slot, q's slot, acceptance)."""
        return self.n_samples * self.max_ploidy * n_alleles + 3 * len(self.pairs)


def _check_inputs(rh, counts, freqs, n_valid, problem, initial, plan, noise, n_steps):
    N, S, R, H = rh.shape
    C = problem.shape[0]
    maxp = plan.max_ploidy
    expect = [
        ("rh", rh, torch.float32, (N, S, R, H)),
        ("counts", counts, torch.float32, (N, S, R)),
        ("freqs", freqs, torch.float64, (N, H)),
        ("n_valid", n_valid, torch.int32, (N,)),
        ("problem", problem, torch.int32, (C,)),
        ("initial", initial, torch.int32, (C, S, maxp)),
    ]
    if noise is not None:
        expect.append(("noise", noise, torch.float32, (n_steps, plan.n_draws(H), C)))
    for name, t, dtype, shape in expect:
        if t.device != rh.device:
            raise ValueError(f"{name} is on {t.device}, rh on {rh.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if S != plan.n_samples:
        raise ValueError(f"rh has {S} samples, the plan {plan.n_samples}")
    if min(N, R, H) < 1 or H > 32767:
        raise ValueError(f"rh shape {(N, S, R, H)} outside 1..32767 alleles")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if C and not bool(((problem >= 0) & (problem < N)).all()):
        raise ValueError("problem indices must lie in [0, N)")
    if not bool(((n_valid >= 1) & (n_valid <= H)).all()):
        raise ValueError("n_valid must lie in [1, H]")
    if C:
        slot = torch.arange(maxp, device=rh.device)
        real = slot[None, :] < torch.as_tensor(plan.ploidy, device=rh.device)[:, None]
        nv = n_valid[problem.long()][:, None, None]
        ok = torch.where(real, (initial >= 0) & (initial < nv), initial == -1)
        if not bool(ok.all()):
            raise ValueError("initial alleles must lie in [0, n_valid) (-1 on padding slots)")
    return N, S, R, H, C


def pedigree_sampler(rh, counts, freqs, n_valid, problem, initial, plan, *,
                     n_steps, seed=0, noise=None, chain_offset=0):
    """Run K3 for C chains; see the module docstring.

    On CUDA tensors this launches the kernel (and raises if it cannot);
    on CPU tensors it runs ``pedigree_sampler_plain``.  ``noise``
    f32[n_steps, plan.n_draws(H), C] pins every uniform draw (tests);
    otherwise draws come from Philox4x32-10 keyed by (seed, chain_offset
    + chain), drawn by the kernel on CUDA and by ``philox_step`` on the
    CPU, so both give one chain the same draws.  ``chain_offset`` is
    chain 0's index in the whole block when the block is split over
    launches (``parallel.sharding``).
    """
    _check_inputs(rh, counts, freqs, n_valid, problem, initial, plan, noise, n_steps)
    if not 0 <= chain_offset < 2 ** 32:
        raise ValueError(f"chain_offset {chain_offset} outside [0, 2**32)")
    args = (rh, counts, freqs, n_valid, problem, initial, plan)
    kwargs = dict(n_steps=n_steps, seed=seed, noise=noise)
    if rh.device.type == "cuda":
        return _launch(*args, chain_offset=chain_offset, **kwargs)
    if rh.device.type != "cpu":
        raise ValueError(f"unsupported device {rh.device}")
    return pedigree_sampler_plain(*args, chain_offset=chain_offset, **kwargs)


#: kernel launches made through ``pedigree_sampler`` (CUDA tensors only)
pedigree_sampler.launches = 0


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
        fn = lib.pedigree_sampler_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 9  # rh counts freqs n_valid problem initial noise ints weights
            + [ctypes.c_int] * 10  # the ten offsets into ints
            + [ctypes.c_void_p]  # trace
            + [ctypes.c_int] * 9  # N S R H C maxp n_pairs n_waves n_steps
            + [ctypes.c_uint64]  # seed
            + [ctypes.c_uint32]  # chain_offset
            + [ctypes.c_int]  # warps per block
            + [ctypes.c_void_p]  # stream
        )
        lib.pedigree_sampler_smem_bytes.restype = ctypes.c_int64
        lib.pedigree_sampler_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.pedigree_sampler_max_warps.restype = ctypes.c_int
        lib.pedigree_sampler_max_warps.argtypes = [ctypes.c_int]
        lib.pedigree_sampler_error_string.restype = ctypes.c_char_p
        lib.pedigree_sampler_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def warps_per_block(n_chains, n_sms, max_warps, smem_bytes):
    """Warps in each chain's block.  A chain's updates depend on each
    other, so while every chain has an SM of its own, the most warps the
    kernel takes (``max_warps``, 16 at ploidy <= 4; a block of that size
    fills an SM's registers) shorten each step.  With more chains,
    smaller blocks keep the resident warps busy: a 16-warp block idles
    through its founders' serial sums.  Halve while the blocks would not
    all be resident (down to 4), then while a block's shared memory
    (``smem_bytes(warps)``) would not fit (down to 1).
    """
    warps = max_warps
    while warps > 4 and n_chains * warps > n_sms * max_warps:
        warps //= 2
    while warps > 1 and smem_bytes(warps) > nvcc_build.MAX_SMEM:
        warps //= 2
    return warps


def launch_warps(plan, n_chains, n_reads, device):
    """``warps_per_block`` for ``plan`` on ``device`` (a card)."""
    lib = load_library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return warps_per_block(
        n_chains, sms, lib.pedigree_sampler_max_warps(plan.max_ploidy),
        lambda w: lib.pedigree_sampler_smem_bytes(plan.n_samples, plan.max_ploidy, n_reads, w),
    )


def _launch(rh, counts, freqs, n_valid, problem, initial, plan, *, n_steps, seed, noise,
            chain_offset=0):
    N, S, R, H = rh.shape
    C = problem.shape[0]
    maxp = plan.max_ploidy
    lib = load_library()
    warps = launch_warps(plan, C, R, rh.device)
    smem = lib.pedigree_sampler_smem_bytes(S, maxp, R, warps)
    if smem > nvcc_build.MAX_SMEM:
        raise ValueError(
            f"chain state needs {smem} bytes of shared memory; at most"
            f" {nvcc_build.MAX_SMEM} fit in one block"
        )
    ints, weights, offsets = plan.device_tables(rh.device)
    trace = torch.empty((C, n_steps, S, maxp), dtype=torch.int16, device=rh.device)
    stream = torch.cuda.current_stream(rh.device).cuda_stream
    err = lib.pedigree_sampler_launch(
        rh.data_ptr(), counts.data_ptr(), freqs.data_ptr(), n_valid.data_ptr(),
        problem.data_ptr(), initial.data_ptr(),
        None if noise is None else noise.data_ptr(), ints.data_ptr(),
        weights.data_ptr(), *offsets, trace.data_ptr(), N, S, R, H, C, maxp,
        len(plan.pairs), len(plan.waves), n_steps, seed & 0xFFFFFFFFFFFFFFFF, chain_offset,
        warps, stream,
    )
    if err != 0:
        msg = lib.pedigree_sampler_error_string(err).decode()
        raise RuntimeError(f"pedigree sampler kernel launch failed: {msg}")
    pedigree_sampler.launches += 1
    return trace


# ---------------------------------------------------------------------------
# plain PyTorch version (vectorised over chains)
# ---------------------------------------------------------------------------

_INV_FACT = [1.0 / math.factorial(e) for e in range(MAX_PLOIDY + 1)]
_COMB = [[float(math.comb(n, k)) for k in range(MAX_PLOIDY + 1)] for n in range(MAX_PLOIDY + 1)]


def _poly_mul(q, c, tmax):
    """In place, q <- q * c truncated at degree ``tmax`` (q a list of
    coefficient tensors, c [..., degree + 1]), added in K3's order."""
    for t in range(min(tmax, len(q) - 1), -1, -1):
        s = q[t] * c[..., 0]
        for x in range(1, t + 1):
            s = s + q[t - x] * c[..., x]
        q[t] = s


def trio_log_lin(prog, rp, rq, freqs, tau_p, tau_q, weights):
    """log trio pmf (lambda 0) of progeny rows prog i[..., P] given parent
    rows rp, rq (i[..., P_parent], None when missing) and linear
    frequencies f64[..., H], operation for operation as K3 computes it:
    D + A + B + C, where A and B sum over parent p's gamete compositions
    and C over parent q's, each as the coefficient of z^tau of a product
    over the slots of a polynomial in the gamete dose of the slot's
    allele (a slot that repeats an earlier allele contributes 1); 0 ->
    ``NEG``."""
    wa, wb, wc, wd = (float(w) for w in weights)
    P = prog.shape[-1]
    dev = prog.device
    eq = prog[..., :, None] == prog[..., None, :]
    tri = torch.tril(torch.ones((P, P), dtype=torch.bool, device=dev), -1)
    first = ~torch.any(eq & tri, dim=-1)
    d = torch.where(first, eq.sum(-1), 0)
    zero = torch.zeros_like(d)
    a = zero if rp is None else (rp[..., None, :] == prog[..., :, None]).sum(-1)
    b = zero if rq is None else (rq[..., None, :] == prog[..., :, None]).sum(-1)
    f = torch.gather(freqs.expand(prog.shape[:-1] + freqs.shape[-1:]), -1, prog)
    comb = torch.as_tensor(_COMB, dtype=torch.float64, device=dev)
    inv_fact = torch.as_tensor(_INV_FACT, dtype=torch.float64, device=dev)
    powers = [torch.ones_like(f)]
    for _ in range(P):
        powers.append(powers[-1] * f)
    powers = torch.stack(powers, -1)  # [..., P, P + 1]: f^e
    x = torch.arange(P + 1, device=dev)
    e = d[..., None] - x  # [..., P, P + 1]: the dose left to the other gamete
    ok = e >= 0
    e = e.clamp(min=0)
    uv = torch.where(ok, torch.gather(powers, -1, e) * inv_fact[e], 0.0)  # f^e / e!
    c_a = comb[a[..., None], x]
    polys = (
        (torch.where(ok, c_a * comb[b[..., None], e], 0.0), int(tau_p)),  # A
        (c_a * uv, int(tau_p)),  # B
        (comb[b[..., None], x] * uv, int(tau_q)),  # C
    )
    one = torch.ones(prog.shape[:-1], dtype=torch.float64, device=dev)
    qs = [[one] + [one * 0.0] * P for _ in polys]
    pd = one
    for j in range(P):
        pd = pd * uv[..., j, 0]
        for q, (c, tau) in zip(qs, polys):
            _poly_mul(q, c[..., j, :], tau)
    total = torch.zeros(prog.shape[:-1], dtype=torch.float64, device=dev)
    if wd > 0:
        total = total + wd * pd
    for w, q, (_, tau) in zip((wa, wb, wc), qs, polys):
        if w > 0:
            total = total + w * q[tau]
    return torch.where(total > 0, torch.log(total), NEG)


def _log_mixture(rows_rh, skip=None):
    """Log-sum-exp over slots of [C, R, P] f32 in slot order, leaving out
    slot ``skip`` (int or [C] tensor): running max from -inf, then a sum
    of exp from 0, as the kernel does."""
    C, R, P = rows_rh.shape
    m = torch.full((C, R), -math.inf, dtype=torch.float32, device=rows_rh.device)
    s = torch.zeros((C, R), dtype=torch.float32, device=rows_rh.device)

    if skip is not None:
        skip = torch.as_tensor(skip, device=rows_rh.device).expand(C)[:, None]
    for j in range(P):
        mj = torch.maximum(m, rows_rh[..., j])
        m = mj if skip is None else torch.where(skip == j, m, mj)
    for j in range(P):
        sj = s + torch.exp(rows_rh[..., j] - m)
        s = sj if skip is None else torch.where(skip == j, s, sj)
    return m + torch.log(s)


def _log_add(rest, v):
    """logaddexp(rest, v) in f32 as the kernel computes it."""
    return torch.maximum(rest, v) + torch.log1p(torch.exp(-torch.abs(rest - v)))


def candidate_llks(rh_s, counts_s, rows, k, ploidy):
    """llk of every candidate for slot ``k``: f64[C, H].

    rh_s f32[C, R, H], counts_s f32[C, R], rows i[C, P] (the sample's
    genotype).  Each read's term is logaddexp(rest, rh) in f32, rest the
    log-sum-exp of the other slots; terms are accumulated in f64.
    """
    sub = torch.gather(rh_s, 2, rows.long()[:, None, :ploidy].expand(-1, rh_s.shape[1], -1))
    rest = _log_mixture(sub, skip=k)
    term = _log_add(rest[..., None], rh_s).double()
    return ((term - _LOG_PLOIDY[ploidy]) * counts_s.double()[..., None]).sum(1)


def philox_step(seed, step, n, chains):
    """K3's own draws 0..n-1 of step ``step`` for ``chains`` (int64
    indices in the whole block): f32[len(chains), n].  Draw d of chain c
    is word d % 4 of Philox4x32-10 with key (low 32 bits of seed, c) and
    counter (step, d // 4, 0, high 32 bits of seed), made a uniform by
    ``utils.philox.uniform_f32`` (``csrc/pedigree_sampler.cu``
    ``uniform``)."""
    seed_lo, seed_hi = split_seed(seed)
    q = torch.arange((n + 3) // 4, device=chains.device)[None, :]
    words = philox4x32_10(int(step), q, 0, seed_hi, seed_lo, chains.long()[:, None])
    return uniform_f32(torch.stack(words, dim=-1)).reshape(len(chains), -1)[:, :n]


def pedigree_sampler_plain(rh, counts, freqs, n_valid, problem, initial, plan, *,
                           n_steps, seed=0, noise=None, chain_offset=0):
    """K3's Markov chain in vectorised torch (the reference version).
    Without ``noise`` it draws the kernel's own Philox stream
    (``philox_step``) for chains chain_offset + c."""
    N, S, R, H, C = _check_inputs(rh, counts, freqs, n_valid, problem, initial, plan,
                                  noise, n_steps)
    device = rh.device
    prob = problem.long()
    rhc, cntc, frc = rh[prob], counts[prob], freqs[prob]
    nvc = n_valid.long()[prob]
    alleles = torch.arange(H, device=device)
    valid = alleles[None, :] < nvc[:, None]
    maxp = plan.max_ploidy
    g = initial.long().clone()
    trace = torch.empty((C, n_steps, S, maxp), dtype=torch.int16, device=device)
    chains = chain_offset + torch.arange(C, device=device)
    pair_base = S * maxp * H
    n_draws = plan.n_draws(H)
    log1p = torch.as_tensor(_LOG1P, device=device)

    def trio(xs, override, cand=False):
        """Summed log trio pmfs of samples ``xs`` (one trio configuration)
        with the rows in ``override`` (sample -> [C, H, P] candidate rows
        when ``cand``, else [C, P])."""
        def row(y):
            r = override.get(y)
            if r is None:
                r = g[:, y, : int(plan.ploidy[y])]
                r = r[:, None, :] if cand else r
            return r[..., None, :]  # the group axis

        p, q = (int(r) for r in plan.parents[xs[0]])
        prog = torch.cat([row(x) for x in xs], dim=-2)
        return trio_log_lin(
            prog, None if p < 0 else row(p), None if q < 0 else row(q),
            frc[:, None, None, :] if cand else frc[:, None, :],
            plan.tau[xs[0], 0], plan.tau[xs[0], 1], plan.weights[xs[0]],
        ).sum(-1)

    for step in range(n_steps):
        u_step = noise[step].T if noise is not None else philox_step(seed, step, n_draws, chains)
        for s in plan.order:
            P = int(plan.ploidy[s])
            for k in range(P):
                rows = g[:, s, :P]
                llk = candidate_llks(rhc[:, s], cntc[:, s], rows, k, P)
                options = rows[:, None, :].expand(C, H, P).clone()
                options[..., k] = alleles
                over = {s: options}
                prior = trio([s], over, cand=True)
                for group in plan.child_groups[s]:
                    prior = prior + trio(group, over, cand=True)
                copies = sum(
                    (rows[:, j, None] == alleles).long() for j in range(P) if j != k
                ) if P > 1 else torch.zeros((C, H), dtype=torch.long, device=device)
                logit = llk + prior + log1p[copies]
                d = (s * maxp + k) * H
                u = u_step[:, d:d + H].double()
                score = torch.where(valid, logit - torch.log(-torch.log(u)), -math.inf)
                g[:, s, k] = torch.argmax(score, dim=1)
        for i, ((p, q), groups) in enumerate(zip(plan.pairs, plan.blanket_groups)):
            u = u_step[:, pair_base + 3 * i:pair_base + 3 * i + 3]
            g = _pair_swap(g, p, q, groups, u, rhc, cntc, plan, trio)
        trace[:, step] = g.to(torch.int16)
    return trace


def _pair_swap(g, p, q, groups, u, rhc, cntc, plan, trio):
    """One MH allele swap between samples p != q of every chain."""
    C = g.shape[0]
    ar = torch.arange(C, device=g.device)
    pp, pq = int(plan.ploidy[p]), int(plan.ploidy[q])
    idx_p = torch.clamp((u[:, 0] * pp).long(), max=pp - 1)
    idx_q = torch.clamp((u[:, 1] * pq).long(), max=pq - 1)
    gp, gq = g[:, p, :pp], g[:, q, :pq]
    allele_p, allele_q = gp[ar, idx_p], gq[ar, idx_q]
    proposes = allele_p != allele_q

    def count(rows, a):
        return (rows == a[:, None]).sum(-1).double()

    proposal = count(gp, allele_p) * count(gq, allele_q)
    reversal = (1.0 + count(gp, allele_q)) * (1.0 + count(gq, allele_p))
    lproposal = torch.log(reversal) - torch.log(torch.clamp(proposal, min=1.0))
    gp_new, gq_new = gp.clone(), gq.clone()
    gp_new[ar, idx_p] = allele_q
    gq_new[ar, idx_q] = allele_p

    def llk_delta(s, rows, idx, new_allele, P):
        sub = torch.gather(rhc[:, s], 2, rows[:, None, :].expand(-1, rhc.shape[2], -1))
        rest = _log_mixture(sub, skip=idx)
        old = _log_add(rest, sub[ar, :, idx])
        new = _log_add(rest, rhc[:, s][ar, :, new_allele])
        return ((new.double() - old.double()) * cntc[:, s].double()).sum(1)

    dllk = llk_delta(p, gp, idx_p, allele_q, pp) + llk_delta(q, gq, idx_q, allele_p, pq)
    proposed = {p: gp_new, q: gq_new}
    dprior = sum(trio(xs, proposed) - trio(xs, {}) for xs in groups)
    log_acc = torch.clamp(dllk + dprior + lproposal, max=0.0)
    accept = proposes & (u[:, 2].double() < torch.exp(log_acc))
    g = g.clone()
    g[:, p, :pp] = torch.where(accept[:, None], gp_new, gp)
    g[:, q, :pq] = torch.where(accept[:, None], gq_new, gq)
    return g
