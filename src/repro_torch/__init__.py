"""repro_torch — the PyTorch/CUDA port of the SwitchAgg package ``repro``.

Same subpackage layout and module names as the JAX package, so each
module has an obvious counterpart (``repro_torch/core/kvagg.py`` <->
``repro/core/kvagg.py``).  The port imports ``torch`` and numpy, never
``jax`` and never anything of ``repro``: the jax-free modules it needs
(``net/wire.py``, ``core/reduction_model.py``, ``obs/``) are copies.

Functions that take tensors run where their tensors lie.  Entry points
that build tensors from numpy or from a seed take ``device=`` and default
to ``"cuda"``; without a card they raise unless the caller passes
``device="cpu"`` — nothing quietly moves to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is present (the entry points' no-silent-CPU rule)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU")
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """numpy (bf16 included) or a tensor -> a tensor on ``device``.  numpy
    input is copied first: arrays handed out by other frameworks may be
    read-only, which ``torch.from_numpy`` does not support."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.array(x)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)
