"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; without one this raises rather than
    falling back to the host. ``"cpu"`` selects the plain PyTorch path that
    the tests use. TF32 is switched off explicitly: every product on the
    path stays float32, as in the JAX reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the host"
            )
        device = "cuda"
    return torch.device(device)


def card_description(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (every
    measurement is written down beside them); ``"cpu"`` for the host."""
    if device.type != "cuda":
        return str(device)
    import subprocess

    # matched by UUID: under CUDA_VISIBLE_DEVICES torch's index is not nvidia-smi's
    uuid = f"GPU-{torch.cuda.get_device_properties(device).uuid}"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    cards = dict(line.split(", ", 1) for line in out.strip().splitlines())
    return cards[uuid]
