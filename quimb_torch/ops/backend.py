"""Host <-> device transfers: the one place arrays cross between numpy
and torch."""

import numpy as np
import torch


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
