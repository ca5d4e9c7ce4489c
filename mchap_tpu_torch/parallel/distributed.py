"""Multi-process runs: process-group set-up, rank layout and output gating.

Port of ``mchap_tpu/parallel/distributed.py``.  Every process runs the
same ``mchap`` command on the same inputs; each takes a contiguous share
of every block's (locus, sample) problems (``parallel.sharding``) and
the shares' results are all-gathered, so every process holds the whole
result and only rank 0 writes the VCF.  Activation is env-gated, so a
single-process run is untouched:

- ``MCHAP_DISTRIBUTED=1`` (or ``auto``): ``init_process_group`` from the
  ``env://`` variables that ``torchrun`` sets (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the
  card);
- ``MCHAP_DISTRIBUTED=<host>:<port>,<world_size>,<rank>``: explicit
  wiring, ``tcp://<host>:<port>``, each process passing its own rank.

``MCHAP_EMIT_ALL_HOSTS=1`` makes every rank emit.  The group's backend
is gloo: what crosses processes here is host data (gathered traces,
pooled INFO sums), and gloo takes any layout, two ranks on one card
included, which NCCL refuses ("Duplicate GPU detected").  A group that
cannot form raises; nothing falls back to a single-process run.
``python -m mchap_tpu_torch.parallel.launch`` starts N local processes.
"""

import datetime
import os

import torch
import torch.distributed as dist

#: how long a rank waits for the others, in set-up and in each
#: collective, before it raises (gloo's default is 30 minutes)
TIMEOUT = datetime.timedelta(minutes=10)


def maybe_initialize():
    """Join the process group that ``MCHAP_DISTRIBUTED`` names; True if
    this process is (now) in one.  Idempotent."""
    spec = os.environ.get("MCHAP_DISTRIBUTED", "").strip()
    if not spec or spec == "0":
        return False
    if dist.is_initialized():
        return True
    if spec in ("1", "auto"):
        dist.init_process_group("gloo", init_method="env://", timeout=TIMEOUT)
        return True
    try:
        address, world_size, rank = spec.split(",")
        world_size, rank = int(world_size), int(rank)
    except ValueError as e:
        raise ValueError(
            "MCHAP_DISTRIBUTED must be '1', 'auto', or "
            f"'<host>:<port>,<world_size>,<rank>' (got {spec!r})"
        ) from e
    dist.init_process_group(
        "gloo", init_method=f"tcp://{address.strip()}", world_size=world_size,
        rank=rank, timeout=TIMEOUT,
    )
    return True


def world():
    """(rank, world size) of this process; (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device):
    """The device this rank runs on when the caller asked for ``device``:
    ``cuda:(local_rank % device_count)`` for a card, the CPU for the
    CPU."""
    if device.type != "cuda":
        return device
    rank = world()[0]
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def all_gather(obj):
    """Every rank's ``obj``, in rank order (a list of one outside a
    group).  Objects cross as pickles through the gloo group."""
    rank, size = world()
    if size == 1:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(tensor):
    """``tensor`` summed over the ranks (itself outside a group); the sum
    crosses processes on the host and comes back on ``tensor``'s device."""
    if world()[1] == 1:
        return tensor
    host = tensor.detach().to("cpu", copy=True)
    dist.all_reduce(host, op=dist.ReduceOp.SUM)
    return host.to(tensor.device)


def is_output_process():
    """True where this process should write the VCF: rank 0 of a group,
    every process outside one, or everywhere with
    ``MCHAP_EMIT_ALL_HOSTS=1``."""
    if os.environ.get("MCHAP_EMIT_ALL_HOSTS", "").strip() in ("1", "true"):
        return True
    return world()[0] == 0
