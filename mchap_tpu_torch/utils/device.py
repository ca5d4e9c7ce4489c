"""Device resolution for the port's entry points."""

import torch


def resolve_device(name="cuda"):
    """``cuda`` (the default) -> the first CUDA device; ``cpu`` on request.

    ``cuda`` without a visible card raises: the port never moves work to
    the CPU behind the user's back.
    """
    if isinstance(name, torch.device):
        device = name
    else:
        name = (name or "cuda").lower()
        if name not in ("cuda", "cpu") and not name.startswith("cuda:"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
        device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the port runs on the GPU by default"
            " (pass --device cpu, or device='cpu', to run on the CPU)"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def memory_budget(device):
    """Bytes one batched call may fill with its temporaries on ``device``:
    a quarter of what the card has free, counting what PyTorch's
    allocator holds unused; 2 GiB on the CPU."""
    if device.type != "cuda":
        return 2 << 30
    free = torch.cuda.mem_get_info(device)[0]
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return (free + cached) // 4
