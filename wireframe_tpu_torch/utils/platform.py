"""Device selection for the port's entry points.

Entry points run on CUDA by default.  The CPU is used only when the
caller asks for it (`device="cpu"`, as the tests do); with no GPU and no
explicit request they raise instead of quietly running on the CPU.
`card_line` names the card a measurement ran on.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def card_line(device: Union[str, torch.device] = "cuda") -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them (a card below its
    maximum power runs slower under load), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    index = torch.device(device).index
    return out[index or 0].strip()
