"""MERA: the multi-scale entanglement renormalization ansatz.

Port of quimb_tpu's ``tensor/tn1d/mera.py`` (reference
``quimb/tensor/tn1d/mera.py``: ``MERA`` :18, ``rand`` :169,
``rand_invar`` :205): a binary 1D MERA on ``L = 2**n`` sites of
disentanglers (tag 'UNI') and isometries (tag 'ISO') with layer tags
``_LAYER{i}``. The random tensors are numpy draws, as quimb_tpu's are,
including the module's generator ``_RNG`` that :meth:`MERA.rand`
replaces: one seed gives both packages the same arrays. The tensors are
made on ``device`` (the GPU unless another is given).
"""

import math

import numpy as np
import torch

from ...ops.backend import resolve_device
from ...utils import oset
from ..core import Tensor, TensorNetwork, rand_uuid
from .core import TensorNetwork1DVector


class MERA(TensorNetwork1DVector):
    """Binary 1D MERA on ``L = 2**n`` sites (periodic): layers of 2-site
    unitaries (disentanglers, tag 'UNI') and 2 -> 1 isometries (tag
    'ISO'), capped by a 'TOP' tensor."""

    _EXTRA_PROPS = ("_site_tag_id", "_site_ind_id", "_L")

    def __init__(self, L, uni=None, iso=None, phys_dim=2, dangle=False,
                 site_ind_id="k{}", site_tag_id="I{}", device=None,
                 **tn_opts):
        if hasattr(L, "tensor_map"):
            TensorNetwork.__init__(self, L)
            return
        nlayers = round(math.log2(L))
        if 2**nlayers != L:
            raise ValueError("MERA needs L a power of 2")
        self._L = L
        self._site_ind_id = site_ind_id
        self._site_tag_id = site_tag_id
        device = resolve_device(device)

        def arr(x, shape):
            return torch.as_tensor(np.asarray(x), device=device).reshape(
                shape)

        d = phys_dim
        tensors = []
        cur = [site_ind_id.format(i) for i in range(L)]
        nsite = L
        for layer in range(nlayers):
            ltag = f"_LAYER{layer}"
            if nsite == 1:
                break
            # disentanglers on pairs (2i+1, 2i+2), periodic
            new_u = list(cur)
            if nsite > 2:
                for i in range(nsite // 2):
                    a, b = (2 * i + 1) % nsite, (2 * i + 2) % nsite
                    ua, ub = rand_uuid(), rand_uuid()
                    data = uni[layer][i] if uni is not None else _rand_uni(d)
                    tensors.append(Tensor(
                        arr(data, (d, d, d, d)),
                        inds=(ua, ub, cur[a], cur[b]),
                        tags=oset(("UNI", ltag, site_tag_id.format(a),
                                   site_tag_id.format(b)))))
                    new_u[a], new_u[b] = ua, ub
            # isometries on pairs (2i, 2i+1) -> coarse site i
            new_c = []
            for i in range(nsite // 2):
                a, b = 2 * i, 2 * i + 1
                out = rand_uuid()
                data = iso[layer][i] if iso is not None else _rand_iso(d)
                tensors.append(Tensor(
                    arr(data, (d, d, d)), inds=(new_u[a], new_u[b], out),
                    tags=oset(("ISO", ltag, site_tag_id.format(a),
                               site_tag_id.format(b))),
                    left_inds=(new_u[a], new_u[b])))
                new_c.append(out)
            cur = new_c
            nsite //= 2
        tensors.append(Tensor(
            arr(_rand_vec(d ** len(cur)), tuple(d for _ in cur)),
            inds=tuple(cur), tags=oset(("TOP", "_LAYER_TOP"))))
        TensorNetwork.__init__(self, tensors, virtual=True, **tn_opts)

    @classmethod
    def rand(cls, L, phys_dim=2, dtype="float64", seed=None, **kwargs):
        global _RNG
        _RNG = np.random.default_rng(seed)
        return cls(L, phys_dim=phys_dim, **kwargs)

    @classmethod
    def rand_invar(cls, L, phys_dim=2, seed=None, **kwargs):
        """Scale-invariant MERA: one disentangler and one isometry for
        every layer."""
        rng = np.random.default_rng(seed)
        nlayers = round(math.log2(L))
        u_layer = _rand_uni(phys_dim, rng)
        i_layer = _rand_iso(phys_dim, rng)
        uni = [[u_layer] * (L // 2) for _ in range(nlayers)]
        iso = [[i_layer] * (L // 2) for _ in range(nlayers)]
        return cls(L, uni=uni, iso=iso, phys_dim=phys_dim, **kwargs)

    @classmethod
    def from_fill_fn(cls, fill_fn, L, D=None, phys_dim=2, block_size=2,
                     cyclic=True, uni_fill_fn=None, iso_fill_fn=None,
                     cap_fill_fn=None, **kwargs):
        """A MERA whose tensors come from ``fill_fn(shape)`` (reference
        ``MERA.from_fill_fn`` merabuilder.py:648; the bond dimension
        follows ``phys_dim``)."""
        d = phys_dim
        ufn = uni_fill_fn or fill_fn
        ifn = iso_fill_fn or fill_fn
        uni, iso, n = [], [], L
        for _ in range(round(math.log2(L))):
            uni.append([ufn((d * d, d * d)) for _ in range(n // 2)])
            iso.append([ifn((d * d, d)) for _ in range(n // 2)])
            n //= 2
        return cls(L, uni=uni, iso=iso, phys_dim=phys_dim, **kwargs)

    @property
    def num_layers(self):
        """The number of coarse-graining layers: log2(L)."""
        return round(math.log2(self._L))

    def isometrize(self, method="qr", inplace=False):
        """Project every UNI and ISO tensor to exact isometric form, and
        normalize the TOP tensor."""
        mera = self if inplace else self.copy()
        for t in mera:
            if "TOP" in t.tags:
                t.normalize_()
            elif "ISO" in t.tags or "UNI" in t.tags:
                t.isometrize_(left_inds=t.inds[:2], method=method)
        return mera


_RNG = np.random.default_rng()


def _rand_uni(d, rng=None):
    rng = rng or _RNG
    q, r = np.linalg.qr(rng.standard_normal((d * d, d * d)))
    return q * np.sign(np.diag(r))


def _rand_iso(d, rng=None):
    rng = rng or _RNG
    q, r = np.linalg.qr(rng.standard_normal((d * d, d)))
    return q * np.sign(np.diag(r))


def _rand_vec(n, rng=None):
    rng = rng or _RNG
    v = rng.standard_normal(n)
    return v / np.linalg.norm(v)
