"""Carry arrays and operators between quimb_tpu and quimb_torch.

An MPS or MPO crosses as its tensors' numpy arrays, with their index
names and tags, into the port's class; raw lists of arrays (the uniform
layout of the DMRG engine, MPO tensors ``(wl, wr, u, d)`` and MPS tensors
``(l, p, r)``) cross as lists of tensors; a sparse
Hamiltonian of the exact layer crosses as its scipy matrix; a tensor or
a tensor network crosses with its arrays read as numpy arrays and its
``inds`` and ``tags`` kept; a circuit crosses as its list of gates; a PEPS or PEPO
crosses like an MPS, and a SimpleUpdate's gauge dict as its vectors; an
arbitrary-geometry network crosses with its class and its site ids, and a 3D
network (``TensorNetwork3D``, ``PEPS3D``) with its class, its lattice size
and its tag and index ids; a MERA with its
tensors' ``left_inds`` and its ids; a ``SparseOperatorBuilder`` as its raw
terms, Hilbert space and settings.
Tensors land on ``device``, the GPU unless the caller names another.
"""

import numpy as np

from .core import LocalTermsHam, SparseHam
from .ops.backend import resolve_device, to_device, to_host


def _from_tpu_network(tn, cls, device, dtype, **ids):
    """quimb_tpu's 1D network ``tn`` -> the port's ``cls`` with the same
    tensors, index names and tags, its arrays read as numpy arrays."""
    from .tensor.core import Tensor, TensorNetwork

    device = resolve_device(device)
    new = TensorNetwork([
        Tensor(to_device(np.asarray(t.data), device=device, dtype=dtype),
               inds=tuple(t.inds), tags=tuple(t.tags))
        for t in tn.tensor_map.values()], virtual=True)
    new.view_as_(cls, L=tn.L, site_tag_id=tn.site_tag_id, **ids)
    return new


def from_tpu_mps(mps, device=None, dtype=None):
    """A quimb_tpu ``MatrixProductState`` -> the port's, with the same
    site tags, site and bond index names, and arrays (read as numpy).
    quimb_tpu draws random states from JAX's generator, which torch
    cannot reproduce: carry them across with this."""
    from .tensor.tn1d.core import MatrixProductState

    return _from_tpu_network(mps, MatrixProductState, device, dtype,
                             site_ind_id=mps.site_ind_id)


def from_tpu_mpo(mpo, device=None, dtype=None):
    """A quimb_tpu ``MatrixProductOperator`` -> the port's, with the same
    site tags, index names and arrays."""
    from .tensor.tn1d.core import MatrixProductOperator

    return _from_tpu_network(mpo, MatrixProductOperator, device, dtype,
                             upper_ind_id=mpo.upper_ind_id,
                             lower_ind_id=mpo.lower_ind_id)


def _from_tpu_2d(tn, cls, device, dtype, **ids):
    """quimb_tpu's 2D network ``tn`` -> the port's ``cls`` with the same
    tensors, index names and tags, its arrays read as numpy arrays."""
    from .tensor.core import Tensor, TensorNetwork

    device = resolve_device(device)
    new = TensorNetwork([
        Tensor(to_device(np.asarray(t.data), device=device, dtype=dtype),
               inds=tuple(t.inds), tags=tuple(t.tags))
        for t in tn.tensor_map.values()], virtual=True)
    new.view_as_(cls, Lx=tn.Lx, Ly=tn.Ly, site_tag_id=tn.site_tag_id,
                 x_tag_id=tn.x_tag_id, y_tag_id=tn.y_tag_id, **ids)
    new.exponent = getattr(tn, "exponent", 0.0)
    return new


def from_tpu_peps(peps, device=None, dtype=None):
    """A quimb_tpu ``PEPS`` -> the port's, with the same site and row /
    column tags, site and bond index names, and arrays (read as numpy).
    quimb_tpu's ``PEPS.rand`` draws from JAX's generator, which torch
    cannot reproduce: carry such a state across with this."""
    from .tensor.tn2d.core import PEPS

    return _from_tpu_2d(peps, PEPS, device, dtype,
                        site_ind_id=peps.site_ind_id)


def from_tpu_pepo(pepo, device=None, dtype=None):
    """A quimb_tpu ``PEPO`` -> the port's, with the same tags, index names
    and arrays."""
    from .tensor.tn2d.core import PEPO

    return _from_tpu_2d(pepo, PEPO, device, dtype,
                        upper_ind_id=pepo._upper_ind_id,
                        lower_ind_id=pepo._lower_ind_id)


def from_tpu_gauges(gauges, device=None, dtype=None):
    """A SimpleUpdate's gauge dict (bond pair -> vector) from quimb_tpu ->
    the same keys with the vectors as tensors on ``device``."""
    device = resolve_device(device)
    return {tuple(map(tuple, k)): to_device(np.asarray(v), device=device,
                                             dtype=dtype)
            for k, v in gauges.items()}


def from_tpu_tngen(tn, device=None, dtype=None):
    """A quimb_tpu ``TensorNetworkGen``, ``TensorNetworkGenVector``,
    ``TensorNetworkGenOperator`` or ``TensorNetworkGenIso`` (with its
    layering state) -> the port's class of the same name, with
    the same tensors (in the same order, so the same bond order), index
    names, tags, ``sites``, ``site_tag_id`` and ``site_ind_id`` (or upper
    and lower index ids), its arrays read as numpy arrays."""
    from .experimental import merabuilder
    from .tensor.core import Tensor, TensorNetwork
    from .tensor.tnag import core as ag
    from .utils import oset

    name = type(tn).__name__
    cls = getattr(merabuilder if name == "TensorNetworkGenIso" else ag, name)
    ids = {ep.lstrip("_"): getattr(tn, ep) for ep in cls._EXTRA_PROPS}
    device = resolve_device(device)
    new = TensorNetwork([
        Tensor(to_device(np.asarray(t.data), device=device, dtype=dtype),
               inds=tuple(t.inds), tags=tuple(t.tags),
               left_inds=getattr(t, "left_inds", None))
        for t in tn.tensor_map.values()], virtual=True)
    new = new.view_as_(cls, **ids)
    if name == "TensorNetworkGenIso" and hasattr(tn, "_open"):
        # the layering state, so that more layers can be added
        new._device = device
        new._phys_dim = tn._phys_dim
        new._nlayer = tn._nlayer
        new._open = dict(tn._open)
        new._open_dims = dict(tn._open_dims)
        new._cone = {s: oset(c) for s, c in tn._cone.items()}
    return new


def from_tpu_mera(mera, device=None, dtype=None):
    """A quimb_tpu ``MERA`` -> the port's :class:`MERA` with the same
    tensors (in the same order), index names, tags and ``left_inds``, and
    its ``L``, ``site_tag_id`` and ``site_ind_id``."""
    from .tensor.core import Tensor, TensorNetwork
    from .tensor.tn1d.mera import MERA

    device = resolve_device(device)
    new = TensorNetwork([
        Tensor(to_device(np.asarray(t.data), device=device, dtype=dtype),
               inds=tuple(t.inds), tags=tuple(t.tags),
               left_inds=t.left_inds)
        for t in mera.tensor_map.values()], virtual=True)
    new.__class__ = MERA
    for ep in MERA._EXTRA_PROPS:
        setattr(new, ep, getattr(mera, ep))
    return new


def from_tpu_tn3d(tn, device=None, dtype=None):
    """A quimb_tpu ``TensorNetwork3D``, ``TensorNetwork3DVector`` or
    ``PEPS3D`` -> the port's class of the same name, with the same tensors
    (in the same order), index names, tags, ``Lx``, ``Ly``, ``Lz`` and tag
    and index ids, its arrays read as numpy arrays."""
    from .tensor.core import Tensor, TensorNetwork
    from .tensor.tn3d import core as t3

    cls = getattr(t3, type(tn).__name__)
    ids = {ep.lstrip("_"): getattr(tn, ep) for ep in cls._EXTRA_PROPS}
    device = resolve_device(device)
    new = TensorNetwork([
        Tensor(to_device(np.asarray(t.data), device=device, dtype=dtype),
               inds=tuple(t.inds), tags=tuple(t.tags))
        for t in tn.tensor_map.values()], virtual=True)
    new.exponent = getattr(tn, "exponent", 0.0)
    return new.view_as_(cls, **ids)


def from_tpu_arrays(Ws, As, device=None, dtype=None):
    """Raw lists, such as quimb_tpu's ``dmrg._mpo_uniform_arrays(H)`` and
    ``dmrg._mps_uniform_arrays(psi)`` (numpy arrays) -> lists of tensors
    on ``device``."""
    device = resolve_device(device)
    return ([to_device(W, device=device, dtype=dtype) for W in Ws],
            [to_device(A, device=device, dtype=dtype) for A in As])


def from_tpu_operator(H, device=None):
    """A scipy matrix from quimb_tpu's ``ham_from_terms(..., sparse=True)``
    -> the port's :class:`LocalTermsHam` of the local terms quimb_tpu
    recorded on it (``H._quimb_tpu_local_terms``: a tuple and numpy
    arrays, so nothing of JAX), or a :class:`SparseHam` of the matrix
    where it recorded none."""
    lt = getattr(H, "_quimb_tpu_local_terms", None)
    if lt is not None:
        dims, terms = lt
        return LocalTermsHam(dims, terms, device=device)
    return SparseHam(H, device=device)


def from_tpu_tensor(t, device=None):
    """A quimb_tpu ``Tensor`` (or any object with ``data``, ``inds``,
    ``tags`` and ``left_inds``) -> the port's :class:`Tensor` with the same
    indices and tags, its data read through ``np.asarray``."""
    from .tensor.core import Tensor

    data = to_device(np.asarray(t.data), device=resolve_device(device))
    return Tensor(data, inds=tuple(t.inds), tags=tuple(t.tags),
                  left_inds=getattr(t, "left_inds", None))


def from_tpu_tensor_network(tn, device=None):
    """A quimb_tpu ``TensorNetwork`` -> the port's :class:`TensorNetwork`
    of the same tensors, in the same order, with its ``exponent``."""
    from .tensor.core import TensorNetwork

    new = TensorNetwork([from_tpu_tensor(t, device=device)
                         for t in tn.tensor_map.values()], virtual=True)
    new.exponent = getattr(tn, "exponent", 0.0)
    return new


def from_tpu_gates(gates):
    """quimb_tpu's ``Circuit.gates`` -> the port's ``Gate`` objects, with
    the same label, parameters, qubits, controls, round, parametrization
    and tags; a raw gate's array is read as a numpy array. A circuit's
    gates are its parameters: ``Circuit.from_gates(from_tpu_gates(...))``
    rebuilds any quimb_tpu circuit in the port."""
    from .tensor.circuit.gates import Gate

    return [
        Gate(g.label, g.params, g.qubits, controls=g.controls,
             round=g.round, parametrize=g.parametrize, tags=g.tags,
             array=None if g.label != "RAW" else to_host(g.array))
        for g in gates
    ]


def from_tpu_operator_builder(b):
    """A quimb_tpu ``SparseOperatorBuilder`` -> the port's, with the same raw
    terms (an explicit 2x2 factor rebuilt from quimb_tpu's key, its entries
    rounded to 14 decimals as the key holds them), the same Hilbert space
    (sites, their order, symmetry and sector) and the same Jordan-Wigner,
    Pauli-decomposition, tolerance and dtype settings."""
    from .operator import HilbertSpace, SparseOperatorBuilder

    hs = None
    if b._hilbert_space is not None:
        old = b._hilbert_space
        hs = HilbertSpace(old.sites, symmetry=old.symmetry,
                          sector=old.sector)
        hs.set_ordering(old.sites)
    new = SparseOperatorBuilder(
        hilbert_space=hs, dtype=b._dtype,
        jordan_wigner=b._transform_jordan_wigner,
        pauli_decompose=b._transform_pauli_decompose, atol=b._atol)
    for ops, coeff in b._terms_raw.items():
        new.add_term(coeff, *(
            (op if isinstance(op, str)
             else np.asarray(op, dtype=complex).reshape(2, 2), site)
            for op, site in ops))
    return new


def to_numpy(tensors):
    """A list of tensors -> a list of numpy arrays."""
    return [to_host(t) for t in tensors]
