"""Approximate spectral functions of tensor networks viewed as linear
operators: port of quimb_tpu's ``tensor/tensor_approx_spectral.py``
(reference ``quimb/tensor/tensor_approx_spectral.py``), SLQ on a
:class:`TNLinearOperator` such as an MPS block's reduced density matrix.
Each Lanczos step contracts the network once for the whole wave of
probes (the operator's ``matmat``)."""

from ..linalg.approx_spectral import approx_spectral_function
from .linop import TNLinearOperator


def tensor_network_approx_spectral_function(tn, f, left_inds=None,
                                            right_inds=None, **kwargs):
    """``Tr f(A)``, where ``A`` is ``tn`` as a linear operator from
    ``right_inds`` to ``left_inds`` (or ``tn`` itself, a
    :class:`TNLinearOperator`)."""
    A = (tn if isinstance(tn, TNLinearOperator)
         else TNLinearOperator(tn, left_inds, right_inds))
    return approx_spectral_function(A, f, **kwargs)


__all__ = ["tensor_network_approx_spectral_function"]
