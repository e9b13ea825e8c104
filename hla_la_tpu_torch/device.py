"""Explicit device selection for the port.

``resolve`` turns a name or ``torch.device`` into the device the port runs
on.  It never falls back: asking for ``cuda`` on a machine without a usable
card raises.  It also pins float32 matrix products to full float32 (TF32
off), because the reference's likelihood dots are full float32
(``hla_la_tpu/ops/pair_ll.py:159-162``).
"""

from __future__ import annotations

import numpy as np

from ._lazy import torch


def resolve(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but "
                               "torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev


def to_device(x, dev: torch.device) -> torch.Tensor:
    """A numpy array is copied to `dev`; a tensor must already be there."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if x.device.type != dev.type:
        raise ValueError(f"tensor on {x.device}, expected {dev}")
    return x


def on_card(t: torch.Tensor) -> bool:
    """The wrappers' one dispatch rule: a CUDA tensor launches the kernel,
    a CPU tensor runs the plain version, anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
