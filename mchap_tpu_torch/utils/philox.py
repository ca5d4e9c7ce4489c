"""Counter-based Philox4x32-10 in torch integer ops: the port's one
random source.

The kernels K0-K3 draw their uniforms from Philox4x32-10 keyed by the
seed and a chain's index in the whole block; every other sampler of the
port (the torch routes and the kernels' plain versions) draws from the
same function here, keyed by a row's global index.  A draw is then a
function of (seed, row, step, draw) alone: how a block is split over
devices and processes cannot change it, and the same call gives the
same bits on the CPU and on a card.

Words are int64 tensors holding values in [0, 2**32).  No intermediate
reaches 2**63: a 32 x 32-bit product is formed from the multiplier's two
16-bit halves, so nothing relies on signed wrap-around.
"""

import torch

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key schedule (Weyl) constants


def _mulhilo(x, m):
    """(high, low) 32-bit words of x * m, for words x and a constant m <
    2**32; every intermediate stays below 2**49."""
    a = x * (m & 0xFFFF)  # < 2**48
    b = x * (m >> 16)  # < 2**48
    s = a + ((b & 0xFFFF) << 16)  # < 2**49
    return (b >> 16) + (s >> 32), s & _MASK


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of counters (c0, c1, c2, c3) under key (k0, k1):
    four int64 word tensors, broadcast together.  Each argument is a
    word tensor (any device) or a Python int in [0, 2**32).  The rounds
    and constants are the kernels' ``philox_word``
    (``csrc/denovo_sampler.cu``), Random123's philox4x32 with 10 rounds."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def uniform_f32(bits):
    """The kernels' f32 uniform of a word: its top 23 bits over 2**23, at
    least 1e-12 (``denovo_sampler.cu`` ``uni_at``)."""
    return ((bits >> 9).to(torch.float32) * (1.0 / 8388608.0)).clamp_(min=1e-12)


def uniform_f64(w0, w1):
    """An f64 uniform in (0, 1) from two words: 21 bits of ``w0`` above
    the 32 of ``w1``, over 2**53; 0 becomes 2**-54."""
    x = ((w0 >> 11) << 32) | w1
    return (x.to(torch.float64) * 2.0 ** -53).clamp_(min=2.0 ** -54)


def split_seed(seed):
    """(low, high) 32-bit words of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def keyed_uniforms(seed, rows, step, n, dtype=torch.float64, out=None):
    """Uniforms [len(rows), n] of ``dtype`` (f32 or f64): draw j of step
    ``step`` for row r.

    ``rows`` holds int64 global row indices (a chain's or a chain-rung's
    place in the whole block) on the device the draws are made on.  Row
    r is the key (seed & 0xFFFFFFFF, r); the counter is (step, j >> 2,
    seed >> 32, 0) in f32, where draw j is ``uniform_f32`` of word j & 3,
    and (step, j >> 1, seed >> 32, 0) in f64, where draw j is
    ``uniform_f64`` of words 2 (j & 1) and 2 (j & 1) + 1.  In f32 this is
    K1's stream with r = chain_offset + chain.  A row's draws depend on
    (seed, r, step, j) only, so any subset of rows, drawn alone, gives
    the same numbers.  With ``out`` the draws are written into it.
    """
    seed_lo, seed_hi = split_seed(seed)
    per = 4 if dtype == torch.float32 else 2
    q = torch.arange((n + per - 1) // per, device=rows.device)
    keys = (rows.long() & _MASK)[:, None]
    w = philox4x32_10(int(step) & _MASK, q[None, :], seed_hi, 0, seed_lo, keys)
    if dtype == torch.float32:
        u = uniform_f32(torch.stack(w, dim=-1))
    elif dtype == torch.float64:
        u = uniform_f64(torch.stack(w[0::2], dim=-1), torch.stack(w[1::2], dim=-1))
    else:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    u = u.reshape(len(rows), -1)[:, :n]
    if out is None:
        return u
    return out.copy_(u)
