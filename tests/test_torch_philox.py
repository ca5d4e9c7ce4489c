"""The port's one random source, ``mchap_tpu_torch/utils/philox.py``.

- ``philox4x32_10`` gives Random123's three philox4x32-10 known answers,
  and the bits of a numpy uint64 reference (the host copy the port used
  before, kept here) on random words, many at or above 2**31.
- ``keyed_uniforms`` keys each row alone: rows [5, 9) of a draw equal a
  draw of those rows by themselves, in f32 and f64, so a block split
  over devices draws what the whole block draws.
- The f32 conversion is the kernels' (top 23 bits over 2**23, at least
  1e-12) and the f64 one takes 53 bits of two words and is never 0.
"""

import numpy as np
import pytest
import torch

from mchap_tpu_torch.utils import philox

torch.set_num_threads(1)


def _philox_numpy(ctr, key):
    """Philox4x32-10 on uint64 arrays holding 32-bit words: each 32 x 32
    bit product is exact in uint64."""
    mask = np.uint64(0xFFFFFFFF)
    c0, c1, c2, c3 = (np.asarray(x, np.uint64) for x in ctr)
    k0, k1 = (np.asarray(x, np.uint64) for x in key)
    for _ in range(10):
        p0 = c0 * np.uint64(0xD2511F53)
        p1 = c2 * np.uint64(0xCD9E8D57)
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & mask,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & mask)
        k0 = (k0 + np.uint64(0x9E3779B9)) & mask
        k1 = (k1 + np.uint64(0xBB67AE85)) & mask
    return c0, c1, c2, c3


@pytest.mark.parametrize("ctr, key, want", [  # Random123's known answers
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_known_answers(ctr, key, want):
    words = philox.philox4x32_10(*(torch.tensor([x]) for x in ctr + key))
    assert tuple(int(w) for w in words) == want
    assert tuple(int(w) for w in _philox_numpy(ctr, key)) == want


def test_matches_numpy_reference_on_random_words():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, size=(6, 4000), dtype=np.uint64)
    words[:, :8] = 0xFFFFFFFF  # the largest word in every position
    assert (words >= 2 ** 31).mean() > 0.4
    got = philox.philox4x32_10(*(torch.from_numpy(w.astype(np.int64)) for w in words))
    want = _philox_numpy(words[:4], words[4:])
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_draw_alone_what_they_draw_in_a_block(dtype):
    """Rows [5, 9) of a 13-row draw are a draw of those rows alone; a
    later step or another seed gives other numbers; ``out`` is filled."""
    seed = (7 << 32) | 0x9E3779B9
    whole = philox.keyed_uniforms(seed, torch.arange(13), 3, 11, dtype)
    part = philox.keyed_uniforms(seed, torch.arange(5, 9), 3, 11, dtype)
    assert whole.shape == (13, 11) and whole.dtype == dtype
    assert torch.equal(part, whole[5:9])
    out = torch.empty((4, 11), dtype=dtype)
    assert philox.keyed_uniforms(seed, torch.arange(5, 9), 3, 11, dtype, out=out) is out
    assert torch.equal(out, part)
    assert not torch.equal(philox.keyed_uniforms(seed, torch.arange(5, 9), 4, 11, dtype), part)
    assert not torch.equal(philox.keyed_uniforms(seed + 1, torch.arange(5, 9), 3, 11, dtype),
                           part)


def test_f32_and_f64_conversions():
    bits = torch.tensor([0, 511, 512, 0xFFFFFFFF, 0x80000000])
    u = philox.uniform_f32(bits)
    assert u.dtype == torch.float32
    assert u.tolist() == [np.float32(1e-12), np.float32(1e-12), 2.0 ** -23,
                          1.0 - 2.0 ** -23, 0.5]
    v = philox.uniform_f64(torch.tensor([0, 0xFFFFFFFF]), torch.tensor([0xFFFFFFFF] * 2))
    assert v.dtype == torch.float64
    assert v.tolist() == [2.0 ** -53 * 0xFFFFFFFF, 1.0 - 2.0 ** -53]
    assert philox.uniform_f64(torch.tensor([0]), torch.tensor([0])).item() == 2.0 ** -54
    # draw j of a row: f32 word j & 3 of counter (step, j >> 2, seed >> 32, 0);
    # f64 words 2 (j & 1) and 2 (j & 1) + 1 of counter (step, j >> 1, ...)
    seed, row, step = (3 << 32) | 17, 5, 2
    words = _philox_numpy((step, 1, 3, 0), (17, row))
    f32 = philox.keyed_uniforms(seed, torch.tensor([row]), step, 8, torch.float32)[0]
    assert f32[6].item() == max(np.float32(int(words[2]) >> 9) * np.float32(2.0 ** -23),
                                np.float32(1e-12))
    f64 = philox.keyed_uniforms(seed, torch.tensor([row]), step, 4, torch.float64)[0]
    x = ((int(words[2]) >> 11) << 32) | int(words[3])
    assert f64[3].item() == x * 2.0 ** -53
    u = philox.keyed_uniforms(1, torch.arange(64), 0, 256, torch.float64)
    assert 0 < u.min() and u.max() < 1 and abs(u.mean().item() - 0.5) < 0.01
