"""Device helpers.

``torch.tensor(values, device="cuda")`` (and indexing a CUDA tensor with a
Python list) copies host memory with a blocking copy that waits for the
stream to drain.  ``const`` stages the values on the host and copies them
asynchronously, so the step keeps the device queue full and never waits.

``device_or_card`` is the default of every function that makes tensors
without an input tensor to take the device from: the card, unless the
caller names another device (the CPU tests pass ``"cpu"``).

``full_float32`` pins float32 matmuls to full precision for a block (the
solvers' Hessians lose millimetres in TF32), and ``host`` brings an index
array to numpy for the host-side plan builds.
"""

from __future__ import annotations

import contextlib

import numpy as np
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


@contextlib.contextmanager
def full_float32():
    """float32 matmuls and einsums in full float32 (no TF32) inside the
    block, whatever the caller set; the caller's setting comes back after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def host(x) -> np.ndarray:
    """A tensor (copied from its device) or array-like as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
