"""Marginals of classical partition-function and SAT tensor networks
(reference ``quimb/experimental/tn_marginals.py``).

Two strategies, as in quimb_tpu:

- slicing: fix each output index at each value and contract, one
  contraction per (index, value); exact.
- autodiff: attach a vector of ones to every output index and take one
  gradient of the partition function: one forward and one backward pass
  give all marginals, since ``dZ/dv_ix[s] = Z(ix=s)``. quimb_tpu's
  ``jax.value_and_grad`` is one ``torch.autograd.grad`` here.
"""

import numpy as np
import torch

from ..ops.backend import to_host

__all__ = [
    "compute_all_marginals_via_slicing",
    "compute_all_marginals_via_autodiff",
]


def compute_all_marginals_via_slicing(
    tn, output_inds, optimize=None, normalized=True, **contract_opts
):
    """Marginal distribution of every index in ``output_inds``:
    ``w[ix][s] = Z(ix=s) (/ Z)``."""
    Z = None
    out = {}
    for ix in output_inds:
        vals = []
        for s in range(tn.ind_size(ix)):
            tns = tn.isel({ix: s})
            vals.append(complex(tns.contract(
                ..., optimize=optimize, **contract_opts)).real)
        w = np.array(vals)
        if Z is None:
            Z = w.sum()
        out[ix] = w / Z if normalized else w
    return out


def compute_all_marginals_via_autodiff(
    tn, output_inds, optimize=None, normalized=True
):
    """All marginals from one gradient of the weighted partition
    function: insert ``v_ix`` (ones) on each target index, then
    ``w[ix] = dZ(v)/dv_ix``."""
    from ..tensor.core import Tensor, TensorNetwork

    output_inds = tuple(output_inds)
    t0 = next(iter(tn.tensor_map.values())).data
    vs = [torch.ones(tn.ind_size(ix), dtype=tn.dtype, device=t0.device,
                     requires_grad=True) for ix in output_inds]
    tnw = TensorNetwork(
        [t.copy() for t in tn]
        + [Tensor(v, inds=(ix,)) for v, ix in zip(vs, output_inds)],
        virtual=True, check_collisions=False,
    )
    Z = tnw.contract(..., optimize=optimize)
    Z = Z.real if Z.is_complex() else Z
    grads = torch.autograd.grad(Z, vs)
    Z = float(Z.detach())
    out = {}
    for ix, g in zip(output_inds, grads):
        # torch's gradient of a real function of complex inputs is the
        # conjugate of JAX's: conjugate it back to quimb_tpu's values
        w = to_host(g.conj() if g.is_complex() else g)
        out[ix] = w / Z if normalized else w
    return out
