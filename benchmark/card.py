"""What the run's device is, as the result line names it."""
from __future__ import annotations

import subprocess

import torch


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` prints it, or "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def card(device) -> dict:
    """platform, kind and count of the run's device (one card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "power_limit": power_limit()}
