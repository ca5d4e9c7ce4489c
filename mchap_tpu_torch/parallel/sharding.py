"""Spread a block's (locus, sample) problems over devices and processes.

Port of ``mchap_tpu/parallel/sharding.py``.  The reference scales by
forking one process per locus block (mchap/application/baseclass.py:
360-394); here a block's problems are split along their leading axis
into contiguous, near-equal shards, one per device (every visible card,
or a list the caller pins) and, in a process group
(``parallel.distributed``), per rank.  Each shard runs the block's own
launch on its device, at the block's shapes, and the shards' outputs
are gathered on the host in problem order.

Placement cannot change results where the draws are keyed by chain: K1,
K2 and K3 key their Philox streams by (seed, ``chain_offset`` + chain),
with ``chain_offset`` the shard's first chain in the whole block, so a
sharded run gives the unsharded launch's genotypes and llks bit for bit.
The torch samplers and the kernels' plain versions draw from a
``torch.Generator``; each shard's is seeded with ``shard_seed(seed,
offset)`` (``utils.seeds``), so those runs are reproducible for a given
placement (and at offset 0 unchanged), not placement-free.  ``MCHAP_SHARD=0`` keeps a
process's block on one card.
"""

import contextlib
import os
from collections import namedtuple

import torch

from mchap_tpu_torch.parallel import distributed as _dist
from mchap_tpu_torch.utils import timing as _timing

#: one shard of a block: problems [start, stop) on ``device``, with the
#: caller's arrays cut to those problems and moved there
Shard = namedtuple("Shard", ["start", "stop", "device", "arrays"])


def problem_devices(n_problems, devices="auto", device=None):
    """The devices this process spreads a block of ``n_problems`` over,
    or None to run it whole on ``device``.

    ``"auto"``: every visible card when ``device`` is a card, more than
    one is visible and the block has at least 2 problems
    (``MCHAP_SHARD=0`` turns it off); in a process group, the rank's own
    device (``distributed.rank_device``).  An explicit list pins the
    devices; it may name one card more than once.
    """
    if devices is None:
        return None
    if isinstance(devices, str):
        if devices != "auto":
            raise ValueError(f"devices must be 'auto', None or a list, got {devices!r}")
        device = torch.device("cuda") if device is None else torch.device(device)
        if _dist.world()[1] > 1:
            return [_dist.rank_device(device)]
        if os.environ.get("MCHAP_SHARD", "auto").strip() == "0":
            return None
        if device.type != "cuda" or n_problems < 2 or torch.cuda.device_count() <= 1:
            return None
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("devices must name at least one device")
    return devices


def split(n_problems, n_shards):
    """Contiguous, near-equal [start, stop) blocks of ``n_problems``, one
    per shard; the first ``n_problems % n_shards`` take one more.  No
    padding: a launch takes any problem count."""
    base, extra = divmod(n_problems, n_shards)
    bounds, start = [], 0
    for i in range(n_shards):
        stop = start + base + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def shard_problems(devices, n_problems, *arrays):
    """This process's shards of a block: ``Shard(start, stop, device,
    arrays)`` for each of its non-empty blocks, the arrays (tensors with
    a leading problem axis) cut to the shard's problems and moved to its
    device.  All chains of a problem stay in one shard.

    The block is split over every rank's devices (``len(devices)`` per
    rank) and this rank takes its own; unlike the JAX package, which
    pads the batch to a multiple of the device count by repeating the
    last problem, nothing is padded.  Launches on the shards' devices are
    asynchronous: issue every shard's launch before waiting on any.
    """
    rank, size = _dist.world()
    k = len(devices)
    bounds = split(n_problems, k * size)[rank * k:(rank + 1) * k]
    return [
        Shard(start, stop, dev, tuple(a[start:stop].to(dev) for a in arrays))
        for dev, (start, stop) in zip(devices, bounds)
        if stop > start
    ]


def gather_result(parts):
    """Concatenate the shards' outputs on the host, in problem order.

    ``parts``: this process's shards' outputs in shard order, each a list
    of per-problem results.  In a process group every rank's parts are
    all-gathered first (through the gloo group), so every rank returns
    the whole block.  Every rank must call it, with or without problems.
    """
    out = []
    for rank_parts in _dist.all_gather(parts):
        for part in rank_parts:
            out.extend(part)
    return out


def run_sharded(n_problems, arrays, launch, fetch, *, devices, device, stage=None):
    """Run a block of ``n_problems`` over its shards; every sharded route
    goes through here.

    ``arrays`` (tensors with a leading problem axis) are cut and moved
    per shard (``shard_problems``) over ``problem_devices(n_problems,
    devices, device)``, or all to ``device`` where that is None.
    ``launch(shard)`` issues the shard's work on its device and returns
    what ``fetch`` needs; it runs for every shard before any wait, so
    the cards work at once.  Then every card in use is synchronized
    (both under the timing stage ``stage``, if one is named), ``fetch(shard,
    launched)`` turns each shard's output into a list of per-problem host
    results, and the lists are gathered in problem order over shards and
    ranks (``gather_result``).
    """
    devs = problem_devices(n_problems, devices, device) or [torch.device(device)]
    shards = shard_problems(devs, n_problems, *arrays)
    with _timing.stage(stage) if stage else contextlib.nullcontext():
        runs = [launch(sh) for sh in shards]
        for dev in dict.fromkeys(sh.device for sh in shards):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return gather_result([fetch(sh, run) for sh, run in zip(shards, runs)])
