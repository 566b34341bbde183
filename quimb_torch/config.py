"""Default dtypes, the default device and the precision contract of
quimb_torch.

quimb_tpu runs every float32 matrix product at full float32 precision
(``jax_default_matmul_precision="highest"``). The port keeps that
contract: TF32 is switched off for cuBLAS and cuDNN, once, when the
package is imported.

The default dtype is a thread-local stack, as quimb_tpu's
(``get_default_dtype``, ``set_default_dtype``, the ``default_dtype``
context manager), read by every builder at call time. It starts at
complex128, or at the environment variable ``QUIMB_TORCH_DTYPE`` where it
is set.
"""

import contextlib
import os
import threading

import torch

#: the start of the default-dtype stack when ``QUIMB_TORCH_DTYPE`` is unset
_DEFAULT_DTYPE = "complex128"
#: device of every tensor a builder or entry point makes without an explicit
#: one: the GPU. Without CUDA such a call raises; ``device="cpu"`` asks for
#: the CPU.
DEFAULT_DEVICE = torch.device("cuda")

_REAL_OF = {
    torch.complex128: torch.float64,
    torch.complex64: torch.float32,
    torch.float64: torch.float64,
    torch.float32: torch.float32,
    torch.bfloat16: torch.bfloat16,
}

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_thread_local = threading.local()


def _get_stack(name, default):
    stacks = getattr(_thread_local, "stacks", None)
    if stacks is None:
        stacks = _thread_local.stacks = {}
    return stacks.setdefault(name, [default])


def _as_torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).replace("torch.", ""))


def _dtype_stack():
    return _get_stack(
        "dtype", os.environ.get("QUIMB_TORCH_DTYPE", _DEFAULT_DTYPE))


def get_default_dtype():
    """The current default dtype of states and operators, a torch dtype."""
    return _as_torch_dtype(_dtype_stack()[-1])


def get_default_real_dtype():
    """The real counterpart of the current default dtype."""
    return _REAL_OF[get_default_dtype()]


def set_default_dtype(dtype):
    """Set the default dtype at the top of this thread's stack."""
    _dtype_stack()[-1] = _as_torch_dtype(dtype)


@contextlib.contextmanager
def default_dtype(dtype):
    """Context manager temporarily setting the default dtype."""
    stack = _dtype_stack()
    stack.append(_as_torch_dtype(dtype))
    try:
        yield
    finally:
        stack.pop()
