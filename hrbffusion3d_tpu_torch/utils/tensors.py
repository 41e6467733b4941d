"""Device helpers.

``torch.tensor(values, device="cuda")`` (and indexing a CUDA tensor with a
Python list) copies host memory with a blocking copy that waits for the
stream to drain.  ``const`` stages the values on the host and copies them
asynchronously, so the step keeps the device queue full and never waits.

``device_or_card`` is the default of every function that makes tensors
without an input tensor to take the device from: the card, unless the
caller names another device (the CPU tests pass ``"cpu"``).

``full_float32`` asks for full-precision float32 contractions for a block
on the calling thread only (the solvers' Hessians lose millimetres in
TF32): inside it, ``einsum`` and ``matmul`` below always compute a float32
CUDA contraction as a broadcast product and a sum, which never takes the
TF32 path.  The process-global ``torch.backends.cuda.matmul.allow_tf32`` is
neither read nor written, so a solve on a worker thread takes the same
path whatever the thread that steps the dense pipeline sets, before or
during the solve.  Outside the block, and on the CPU, they are
``torch.einsum`` and ``@``.

``host`` brings an index array to numpy for the host-side plan builds.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_LOCAL = threading.local()


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
    """Full float32 for ``einsum`` / ``matmul`` on this thread inside the
    block, whatever the process-global TF32 flag says (which is not
    touched)."""
    depth = getattr(_LOCAL, "full_float32", 0)
    _LOCAL.full_float32 = depth + 1
    try:
        yield
    finally:
        _LOCAL.full_float32 = depth


def in_full_float32() -> bool:
    """Whether the calling thread is inside ``full_float32``."""
    return bool(getattr(_LOCAL, "full_float32", 0))


def _float32_on_card(x: torch.Tensor) -> bool:
    return x.is_cuda and x.dtype == torch.float32


def _exact_needed(x: torch.Tensor) -> bool:
    """The switch of ``einsum`` / ``matmul``: a float32 CUDA operand on a
    thread inside ``full_float32``."""
    return _float32_on_card(x) and in_full_float32()


def _align(x: torch.Tensor, sub: str, labels: list) -> torch.Tensor:
    """``x`` (subscripts ``sub``) permuted to the order of ``labels`` with a
    size-1 axis for each label it lacks."""
    present = [c for c in labels if c in sub]
    x = x.permute([sub.index(c) for c in present])
    return x.reshape([x.shape[present.index(c)] if c in sub else 1 for c in labels])


def exact_einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` (explicit ``->`` form, no repeated or ellipsis
    labels) as broadcast products and sums, left to right: no matmul, so
    no TF32 whatever the global flag says."""
    ins, out = equation.replace(" ", "").split("->")
    subs = ins.split(",")
    cur_sub, cur = subs[0], operands[0]
    for k in range(1, len(operands)):
        later = set("".join(subs[k + 1:])) | set(out)
        labels = list(dict.fromkeys(cur_sub + subs[k]))
        prod = _align(cur, cur_sub, labels) * _align(operands[k], subs[k], labels)
        gone = [i for i, c in enumerate(labels) if c not in later]
        cur = prod.sum(dim=gone) if gone else prod
        cur_sub = "".join(c for c in labels if c in later)
    gone = [i for i, c in enumerate(cur_sub) if c not in out]
    if gone:
        cur = cur.sum(dim=gone)
        cur_sub = "".join(c for c in cur_sub if c in out)
    return cur.permute([cur_sub.index(c) for c in out])


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``, in full float32 inside ``full_float32``."""
    if _exact_needed(operands[0]):
        return exact_einsum(equation, *operands)
    return torch.einsum(equation, *operands)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for batched matrices (both at least 2-D), in full float32
    inside ``full_float32``."""
    if _exact_needed(a):
        return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)
    return a @ b


def host(x) -> np.ndarray:
    """A tensor (copied from its device) or array-like as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
