"""The arithmetic of the rooflines: the published peaks of one NVIDIA H100
and the operations and bytes of each kernel's work, counted from shapes.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit;
a run states the card's own limit beside its numbers):

- 67 TFLOP/s float64 on the FP64 tensor cores (DMMA), which also bounds
  complex128, counted as four real products each;
- 495 TFLOP/s TF32 on the tensor cores, which bounds float32 products on
  them (the float32 sandwich kernel's 3xTF32 does three TF32 products for
  each float32 one, so it reaches a third of this at most);
- 3.35 TB/s of HBM3.
"""

import torch

PEAK_FLOPS = {torch.float64: 67e12, torch.complex128: 67e12,
              torch.float32: 495e12, torch.complex64: 495e12}
PEAK_BYTES_PER_S = 3.35e12


def sandwich_flops(w, M, K1, K2, N, complex_=False):
    """The operations of ``out = sum_x A[x] @ theta @ B[x]``, A (w, M, K1),
    theta (K1, K2), B (w, K2, N): ``theta @ B[x]`` then ``A[x] @ (...)``,
    a multiply and an add each, four real products each for complex."""
    flops = 2 * w * M * K2 * (K1 + N)
    return 4 * flops if complex_ else flops


def sandwich_bytes(w, M, K1, K2, N, itemsize):
    """A, theta and B read once and the output written once."""
    return (w * M * K1 + K1 * K2 + w * K2 * N + M * N) * itemsize


def sandwich_bound_s(a_shape, b_shape, dtype):
    """The least time of one sandwich matvec: the larger of its operations
    over the dtype's peak and its bytes over the memory rate."""
    (w, M, K1), (_, K2, N) = a_shape, b_shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(sandwich_flops(w, M, K1, K2, N, dtype.is_complex)
               / PEAK_FLOPS[dtype],
               sandwich_bytes(w, M, K1, K2, N, itemsize) / PEAK_BYTES_PER_S)


def sector_matvec_bytes(D, itemsize=8, word=8):
    """The sector matvec's bytes: x read, y written and the D int64
    configuration words read, once each."""
    return D * (2 * itemsize + word)


def sector_matvec_bound_s(D, dtype=torch.float64):
    itemsize = torch.empty((), dtype=dtype).element_size()
    return sector_matvec_bytes(D, itemsize) / PEAK_BYTES_PER_S
