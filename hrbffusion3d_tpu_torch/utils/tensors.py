"""Device helpers.

``torch.tensor(values, device="cuda")`` (and indexing a CUDA tensor with a
Python list) copies host memory with a blocking copy that waits for the
stream to drain.  ``const`` stages the values on the host and copies them
asynchronously, so the step keeps the device queue full and never waits.

``device_or_card`` is the default of every function that makes tensors
without an input tensor to take the device from: the card, unless the
caller names another device (the CPU tests pass ``"cpu"``).
"""

from __future__ import annotations

import torch


def const(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` (nested lists / numpy) as a tensor on ``device``."""
    return torch.as_tensor(values, dtype=dtype).to(device, non_blocking=True)


def device_or_card(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None; raises when the card is
    asked for and there is none (no silent move to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev
