"""Hand-written CUDA kernels of quimb_torch, beside their plain PyTorch
versions.

The sandwich matvec ``out = sum_x a[x] @ theta @ b[x]`` replaces
quimb_tpu's Pallas kernel (``quimb_tpu/ops/pallas_kernels.py:
_sandwich_kernel``). A local solve applies it to many ``theta`` with the
same stacks ``a`` and ``b``, so it comes in two steps: a prepare step
takes the stacks once and returns a callable that applies the matvec to
one ``theta``. :func:`resolve_sandwich` picks the prepare step once,
from the device and the dtype:

- CPU tensors: :func:`prepare_sandwich_reference`, the plain einsum;
- CUDA float32: :func:`prepare_sandwich_tf32`, the 3xTF32 tensor-core
  kernel of ``quimb_torch/csrc/sandwich_tf32.cu``;
- CUDA float64: :func:`prepare_sandwich_f64`, the FP64 tensor-core
  (DMMA) kernel of ``quimb_torch/csrc/sandwich_f64.cu``;
- anything else raises. There is no size gate and no switch: the kernels
  take every shape.

:func:`sandwich_matvec` is the one-shot form (prepare, then apply).
"""

import ctypes
import functools

import torch

from ..tracing import spanned
from . import _build

#: Matvecs launched on the card in this process, by kernel; a prepared
#: operand set adds one to its kernel's count per application. Callers
#: may reset the counts.
LAUNCHES = {"sandwich_tf32": 0, "sandwich_f64": 0}

# both kernels' stacks and scratch are zero-padded to whole tiles: M and N
# to 128 (a wgmma n128 tile; the float64 kernel's 128 x 64 tiles), K1 to 32
# (one 128-byte float32 stage, two float64 ones), K2 to 64 (a warpgroup's
# 64 rows in pass 1, and whole stages in pass 2)
_PAD_M, _PAD_K1, _PAD_K2, _PAD_N = 128, 32, 64, 128


def sandwich_matvec_reference(a, theta, b):
    """``sum_x a[x] @ theta @ b[x]`` as a plain einsum: a (w, M, K1),
    theta (K1, K2), b (w, K2, N) -> (M, N)."""
    return torch.einsum("xmk,kl,xln->mn", a, theta, b)


def _roundup(n, m):
    return -(-n // m) * m


def sandwich_padded_dims(M, K1, K2, N):
    """(Mp, K1p, K2p, Np): the kernels' padded sizes."""
    return (_roundup(M, _PAD_M), _roundup(K1, _PAD_K1),
            _roundup(K2, _PAD_K2), _roundup(N, _PAD_N))


def sandwich_layout(a, b):
    """The kernels' layout of the stacks, in plain torch on any device and
    dtype: a (w, M, K1) -> (w, Mp, K1p) and b (w, K2, N) ->
    b transposed, (w, Np, K2p), both zero-padded. Then
    ``out = sum_x a_p[x] @ theta_p @ b_p[x].T`` with theta zero-padded to
    (K1p, K2p) holds ``sandwich_matvec(a, theta, b)`` in its (M, N)
    corner, and every product reads its operands K-major."""
    w, M, K1, K2, N = _stack_dims(a, b)
    Mp, K1p, K2p, Np = sandwich_padded_dims(M, K1, K2, N)
    ap = a.new_zeros((w, Mp, K1p))
    ap[:, :M, :K1] = a
    bp = b.new_zeros((w, Np, K2p))
    bp[:, :N, :K2] = b.transpose(1, 2)
    return ap, bp


def _tf32_round(x):
    """x float32 rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """x float32 -> (2, *x.shape): ``[big, small]`` with big = tf32(x)
    and small = tf32(x - big), so big + small = x to about 2^-22
    relative. The difference x - big is exact in float32."""
    x = x.contiguous()
    big = _tf32_round(x)
    return torch.stack((big, _tf32_round(x - big)))


def _stack_dims(a, b):
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError("sandwich stacks must be (w,M,K1) and (w,K2,N)")
    w, M, K1 = a.shape
    wb, K2, N = b.shape
    if wb != w:
        raise ValueError(f"sandwich stacks disagree: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if min(w, M, K1, K2, N) < 1:
        raise ValueError(f"sandwich sizes out of range: w={w}, M={M}, "
                         f"K1={K1}, K2={K2}, N={N}")
    return w, M, K1, K2, N


def _check_kernel_target(device, dtype):
    if device.type != "cuda":
        raise ValueError(
            f"the sandwich kernel runs on CUDA tensors, got {device}"
        )
    if dtype.is_complex:
        raise NotImplementedError(
            f"the sandwich kernel is real (float32, float64), got {dtype}"
        )
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"the sandwich kernel takes float32 or float64, got {dtype}"
        )


@functools.cache
def _library():
    lib = _build.load_library()
    sigs = {
        "sandwich_f64_apply": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
        + [ctypes.c_void_p],
        "sandwich_tf32_maps_bytes": [],
        "sandwich_tf32_encode": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
        "sandwich_tf32_apply": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
        + [ctypes.c_void_p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_error(err, what):
    if err != 0:
        raise RuntimeError(f"sandwich kernel {what} failed: CUDA error "
                           f"{err}")


class _Prepared:
    """Stacks laid out for one kernel; calling it with theta (K1, K2)
    launches one matvec on the current stream and returns (M, N).
    The scratch is the operand set's own, so its matvecs run in stream
    order on one stream. A subclass names its kernel's ``LAUNCHES`` key
    and launches it in ``_launch(theta, out, stream)``, which returns the
    kernel's error code."""

    kernel = None

    def __init__(self, a, b):
        _check_kernel_target(a.device, a.dtype)
        if b.device != a.device or b.dtype != a.dtype:
            raise ValueError("sandwich operands must share device and dtype")
        self.dims = w, M, K1, K2, N = _stack_dims(a, b)
        self.device, self.dtype = a.device, a.dtype
        Mp, K1p, K2p, Np = self.padded = sandwich_padded_dims(M, K1, K2, N)
        if 2 * w * max(Mp, Np, K2p) >= 2**31:
            raise ValueError(f"sandwich sizes out of range: w={w}, M={M}, "
                             f"K1={K1}, K2={K2}, N={N}")
        self._new = functools.partial(torch.empty, dtype=a.dtype,
                                      device=a.device)

    def _check_theta(self, theta):
        _, _, K1, K2, _ = self.dims
        if theta.device != self.device or theta.dtype != self.dtype:
            raise ValueError("sandwich operands must share device and dtype")
        if tuple(theta.shape) != (K1, K2):
            raise ValueError(f"theta must be ({K1}, {K2}), got "
                             f"{tuple(theta.shape)}")
        if not theta.is_contiguous():
            raise ValueError("theta must be contiguous")

    @spanned("sandwich")
    def __call__(self, theta):
        self._check_theta(theta)
        _, M, _, _, N = self.dims
        out = torch.empty((M, N), dtype=self.dtype, device=self.device)
        with torch.cuda.device(self.device):
            err = self._launch(
                theta, out, torch.cuda.current_stream(self.device).cuda_stream)
        _check_error(err, "launch")
        LAUNCHES[self.kernel] += 1
        return out


class _PreparedTF32(_Prepared):
    kernel = "sandwich_tf32"

    def __init__(self, a, b):
        super().__init__(a, b)
        w = self.dims[0]
        Mp, K1p, K2p, Np = self.padded
        ap, bp = sandwich_layout(a, b)
        self.a, self.b = tf32_split(ap), tf32_split(bp)
        self.theta_t = self._new((2, K2p, K1p))
        self.t = self._new((2, Mp, w * K2p))
        self.part = self._new((w, Mp, Np))
        lib = _library()
        self._maps = ctypes.create_string_buffer(
            lib.sandwich_tf32_maps_bytes())
        with torch.cuda.device(self.device):
            err = lib.sandwich_tf32_encode(
                ctypes.addressof(self._maps), self.a.data_ptr(),
                self.b.data_ptr(), self.theta_t.data_ptr(),
                self.t.data_ptr(), w, Mp, K1p, K2p, Np)
        _check_error(err, "tensor-map encoding")

    def _launch(self, theta, out, stream):
        return _library().sandwich_tf32_apply(
            ctypes.addressof(self._maps), theta.data_ptr(),
            self.theta_t.data_ptr(), self.t.data_ptr(), self.part.data_ptr(),
            out.data_ptr(), *self.dims, *self.padded, stream)


class _PreparedF64(_Prepared):
    kernel = "sandwich_f64"

    def __init__(self, a, b):
        super().__init__(a, b)
        w = self.dims[0]
        Mp, K1p, K2p, Np = self.padded
        self.a, self.b = sandwich_layout(a, b)
        self.theta_t = self._new((K2p, K1p))
        self.t = self._new((w, Mp, K2p))
        self.part = self._new((w, Mp, Np))

    def _launch(self, theta, out, stream):
        return _library().sandwich_f64_apply(
            theta.data_ptr(), self.theta_t.data_ptr(), self.a.data_ptr(),
            self.b.data_ptr(), self.t.data_ptr(), self.part.data_ptr(),
            out.data_ptr(), *self.dims, *self.padded, stream)


def prepare_sandwich_reference(a, b):
    """The plain version of the prepare step: ``theta ->
    sandwich_matvec_reference(a, theta, b)``."""

    @spanned("sandwich")
    def prepared(theta):
        return sandwich_matvec_reference(a, theta, b)

    return prepared


def prepare_sandwich_tf32(a, b):
    """Prepare float32 CUDA stacks for the 3xTF32 kernel: pad, lay out
    (:func:`sandwich_layout`) and split (:func:`tf32_split`) them once,
    allocate the scratch and encode the tensor maps."""
    return _PreparedTF32(a, b)


def prepare_sandwich_f64(a, b):
    """Prepare float64 CUDA stacks for the FP64 tensor-core kernel: pad
    and lay them out once (:func:`sandwich_layout`) and allocate the
    scratch."""
    return _PreparedF64(a, b)


def resolve_sandwich(device, dtype):
    """The prepare step for operands of ``dtype`` on ``device``: the plain
    version on the CPU and for complex dtypes on CUDA (quimb_tpu's
    ``use_sandwich_kernel`` sends complex operands to its einsum too), a
    kernel's for float32 and float64 on CUDA. Raises for what neither
    takes, so a solver can resolve it once, up front."""
    device = torch.device(device)
    if device.type == "cpu" or (device.type == "cuda" and dtype.is_complex):
        return prepare_sandwich_reference
    _check_kernel_target(device, dtype)
    return {torch.float32: prepare_sandwich_tf32,
            torch.float64: prepare_sandwich_f64}[dtype]


def prepare_sandwich(a, b):
    """Prepare the stacks a (w, M, K1) and b (w, K2, N) with the prepare
    step that :func:`resolve_sandwich` picks for them."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return prepare_sandwich_reference(a, b)
    return resolve_sandwich(a.device, a.dtype)(a, b)


def sandwich_matvec(a, theta, b):
    """``sum_x a[x] @ theta @ b[x]``: a (w, M, K1), theta (K1, K2),
    b (w, K2, N) -> (M, N), in the dtype of the operands.

    On CPU tensors this is :func:`sandwich_matvec_reference`. On CUDA
    tensors (one device, float32 or float64, theta contiguous) it
    prepares the stacks and launches one matvec of the kernel on the
    current stream; anything else raises.
    """
    if all(t.device.type == "cpu" for t in (a, theta, b)):
        return sandwich_matvec_reference(a, theta, b)
    _check_kernel_target(a.device, a.dtype)
    return prepare_sandwich(a, b)(theta)
