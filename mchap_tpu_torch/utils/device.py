"""Device resolution for the port's entry points."""

import torch


def resolve_device(name="auto"):
    """``auto`` -> the first CUDA device when one is visible, else CPU.

    ``cuda`` without a visible card raises: the port never moves work to
    the CPU behind the user's back.
    """
    if isinstance(name, torch.device):
        return name
    name = (name or "auto").lower()
    if name == "auto":
        name = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is visible")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device
