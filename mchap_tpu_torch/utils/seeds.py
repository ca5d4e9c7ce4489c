"""Generator seeds of the pieces of a split block."""

_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def shard_seed(seed, offset):
    """The generator seed of a piece of a block whose first problem (or
    chain) is ``offset`` in the block: ``seed`` itself at offset 0, else
    ``seed`` mixed with the offset.  The torch samplers and the kernels'
    plain versions draw from generators seeded so; the kernels key
    their Philox streams by chain instead."""
    seed = int(seed) & _MASK64
    if offset == 0:
        return seed
    return (seed ^ ((int(offset) * _GOLDEN) & _MASK64)) & _MASK64
