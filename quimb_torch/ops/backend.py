"""Host <-> device transfers: the one place arrays cross between numpy
and torch."""

import numpy as np
import torch

from ..config import DEFAULT_DEVICE


def resolve_device(device):
    """``device``, or the package's default device (the GPU) when it is
    ``None``. Raises when that is a CUDA device and there is none: an
    entry point never falls back to the CPU on its own."""
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return device


def to_device(x, device=None, dtype=None):
    """Array-like or tensor -> tensor on ``device`` with ``dtype`` (either
    left as it is when ``None``). Host arrays are copied, so the tensor
    never shares memory with a (possibly read-only) numpy buffer."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def to_host(x):
    """Tensor or array-like -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().cpu().numpy()
    return np.asarray(x)
