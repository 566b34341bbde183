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


def complex_dtype(dtype):
    """The complex dtype of ``dtype``'s precision: complex64 for float32 and
    complex64, complex128 otherwise."""
    return (torch.complex64 if dtype in (torch.float32, torch.complex64)
            else torch.complex128)


def to_torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a name such as
    ``"complex128"`` or ``"torch.float32"``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    if name not in ("float16", "bfloat16", "float32", "float64",
                    "complex64", "complex128", "int32", "int64", "bool"):
        name = np.dtype(dtype).name
    return getattr(torch, name)


def numpy_dtype(dtype):
    """The numpy dtype of the torch dtype ``dtype``."""
    return torch.empty(0, dtype=dtype).numpy().dtype


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
