"""Hand-written CUDA kernels of quimb_torch, beside their plain PyTorch
versions.

:func:`sandwich_matvec` replaces quimb_tpu's Pallas kernel
(``quimb_tpu/ops/pallas_kernels.py:_sandwich_kernel``). CPU tensors go
through :func:`sandwich_matvec_reference`; CUDA tensors go through the
kernel in ``quimb_torch/csrc/sandwich.cu``, or the call raises. There is
no size gate and no switch: the kernel masks ragged tiles itself.
"""

import ctypes
import functools

import torch

from . import _build

#: Launches of the sandwich kernel in this process; each call of
#: :func:`sandwich_matvec` on CUDA tensors adds one. Callers may reset it.
SANDWICH_LAUNCHES = 0

_SANDWICH_SYMBOLS = {
    torch.float32: "sandwich_matvec_f32",
    torch.float64: "sandwich_matvec_f64",
}


def sandwich_matvec_reference(a, theta, b):
    """``sum_x a[x] @ theta @ b[x]`` as a plain einsum: a (w, M, K1),
    theta (K1, K2), b (w, K2, N) -> (M, N)."""
    return torch.einsum("xmk,kl,xln->mn", a, theta, b)


def _check_kernel_target(device, dtype):
    if device.type != "cuda":
        raise ValueError(
            f"the sandwich kernel runs on CUDA tensors, got {device}"
        )
    if dtype.is_complex:
        raise NotImplementedError(
            f"the sandwich kernel is real (float32, float64), got {dtype}"
        )
    if dtype not in _SANDWICH_SYMBOLS:
        raise TypeError(
            f"the sandwich kernel takes float32 or float64, got {dtype}"
        )


def resolve_sandwich(device, dtype):
    """The sandwich matvec for operands of ``dtype`` on ``device``: the
    plain version on the CPU, the kernel on CUDA. Raises for what the
    kernel does not take, so a solver can resolve it once, up front."""
    device = torch.device(device)
    if device.type == "cpu":
        return sandwich_matvec_reference
    _check_kernel_target(device, dtype)
    return sandwich_matvec


@functools.cache
def _library():
    lib = _build.load_library()
    for name in _SANDWICH_SYMBOLS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def sandwich_matvec(a, theta, b):
    """``sum_x a[x] @ theta @ b[x]``: a (w, M, K1), theta (K1, K2),
    b (w, K2, N) -> (M, N), in the dtype of the operands.

    On CPU tensors this is :func:`sandwich_matvec_reference`. On CUDA
    tensors (contiguous, one device, float32 or float64) it launches the
    hand-written kernel on the current stream and counts the launch in
    :data:`SANDWICH_LAUNCHES`; anything else raises.
    """
    global SANDWICH_LAUNCHES
    tensors = (a, theta, b)
    if all(t.device.type == "cpu" for t in tensors):
        return sandwich_matvec_reference(a, theta, b)
    _check_kernel_target(a.device, a.dtype)
    if any(t.device != a.device or t.dtype != a.dtype for t in tensors):
        raise ValueError("sandwich operands must share device and dtype")
    if a.ndim != 3 or theta.ndim != 2 or b.ndim != 3:
        raise ValueError("sandwich operands must be (w,M,K1), (K1,K2), "
                         "(w,K2,N)")
    w, M, K1 = a.shape
    K2, N = theta.shape[1], b.shape[2]
    if theta.shape[0] != K1 or tuple(b.shape[:2]) != (w, K2):
        raise ValueError(
            f"sandwich shapes disagree: a {tuple(a.shape)}, theta "
            f"{tuple(theta.shape)}, b {tuple(b.shape)}"
        )
    if min(w, M, K1, K2, N) < 1 or w * K2 >= 2**31:
        raise ValueError(f"sandwich sizes out of range: w={w}, M={M}, "
                         f"K1={K1}, K2={K2}, N={N}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sandwich operands must be contiguous")

    fn = getattr(_library(), _SANDWICH_SYMBOLS[a.dtype])
    t = torch.empty((M, w * K2), dtype=a.dtype, device=a.device)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), theta.data_ptr(), b.data_ptr(),
                 t.data_ptr(), out.data_ptr(), w, M, K1, K2, N, stream)
    if err != 0:
        raise RuntimeError(f"sandwich kernel launch failed: CUDA error "
                           f"{err}")
    SANDWICH_LAUNCHES += 1
    return out
