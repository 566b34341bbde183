"""Applying operators ('gates') to tensor network indices.

Port of quimb_tpu's ``tensor/gating.py`` to torch (reference
``quimb/tensor/gating.py``: ``tensor_network_gate_inds`` :330, contract
modes, sandwich gating :642). A gate given as a numpy array stays on the
host when the network's tensors are host arrays (inside
``contract_backend("numpy")``: the lazy circuit builds its whole network
that way and moves only the final contraction's operands to the device),
and joins them on their device when they are torch tensors.

Contract modes:

- ``False``: lazily add the gate as a new tensor (reindexing the TN).
- ``True``: contract the gate into the site tensor(s) (grows bonds for
  multi-site gates on separate tensors).
- ``'split'``: contract with both site tensors then split back with
  truncation (2-site only).
- ``'reduce-split'``: QR-reduce the site tensors towards the bond, gate
  the small cores, split, absorb back — the O(chi^3 d^3) TEBD update
  (2-site only).
- ``'split-gate'`` / ``'auto-split-gate'``: factor the gate itself across
  the bond (spatially decompose), keeping the TN lazy; the automatic form
  does so only when the gate's operator-Schmidt rank is below d^2.
"""

import numpy as np
import torch

from ..ops import decomp
from ..ops.backend import to_device
from ..utils import check_opt
from . import array_ops as ar
from .core import Tensor, bonds, rand_uuid, tags_to_oset, tensor_contract


def _gate_to_tensor(G, dp_out, dp_in):
    """Reshape a raw gate array to (out..., in...) tensor form. A torch
    tensor stays on its device; anything else is read as a host numpy
    array (the lazy circuit keeps its gates on the host)."""
    if not isinstance(G, torch.Tensor):
        G = np.asarray(G)
    n = len(dp_out)
    if G.ndim == 2:
        G = G.reshape((*dp_out, *dp_in))
    elif G.ndim != 2 * n:
        raise ValueError(
            f"gate with {G.ndim} dims doesn't match {n} indices"
        )
    return G


def gate_split_gate(G, n, dp, cutoff=1e-12):
    """Spatially factor a 2-site gate G into two site operators connected
    by a new bond (reference 'split-gate' mode). Returns ``(Gl, Gr, k)``
    with ``k`` the kept rank."""
    # G has inds (o0, o1, i0, i1); group (o0,i0),(o1,i1)
    if isinstance(G, np.ndarray):
        # a (d^2, d^2) SVD on the host
        G4 = np.reshape(G, (dp[0], dp[1], dp[0], dp[1]))
        Gm = np.reshape(np.transpose(G4, (0, 2, 1, 3)),
                        (dp[0] * dp[0], dp[1] * dp[1]))
        u, s, vh = np.linalg.svd(Gm, full_matrices=False)
        keep = int(np.sum(s > cutoff * s[0])) if s.size else 0
        keep = max(keep, 1)
        ss = np.sqrt(s[:keep])
        l = u[:, :keep] * ss
        r = ss[:, None] * vh[:keep]
        Gl = np.reshape(l, (dp[0], dp[0], keep))
        Gr = np.reshape(np.ascontiguousarray(r.T),
                        (dp[1], dp[1], keep))
        return Gl, Gr, keep
    G4 = G.reshape(dp[0], dp[1], dp[0], dp[1])
    Gm = G4.permute(0, 2, 1, 3).reshape(dp[0] * dp[0], dp[1] * dp[1])
    l, _, r = decomp.svd_truncated(Gm, cutoff=cutoff, absorb="both")
    k = l.shape[-1]
    Gl = l.reshape(dp[0], dp[0], k)
    Gr = r.transpose(0, 1).reshape(dp[1], dp[1], k)
    return Gl, Gr, k


def tensor_network_gate_inds(
    tn,
    G,
    inds,
    contract=False,
    tags=None,
    info=None,
    inplace=False,
    **compress_opts,
):
    """Apply a gate ``G`` to indices ``inds`` of ``tn``, keeping the
    outer index names fixed (reference ``tensor_network_gate_inds``
    gating.py:330)."""
    check_opt(
        "contract", contract,
        (False, True, "split", "reduce-split", "swap+split",
         "split-gate", "auto-split-gate"),
    )
    tn = tn if inplace else tn.copy()
    if isinstance(inds, str):
        inds = (inds,)
    inds = tuple(inds)
    ng = len(inds)
    tags = tags_to_oset(tags)

    dp = tuple(tn.ind_size(ix) for ix in inds)
    G = _gate_to_tensor(G, dp, dp)

    tids = tn._get_tids_from_inds(inds, "any")
    # a host gate on a network of torch tensors joins them on their
    # device; a host split-gate factorisation still runs on the host gate
    ref = tn.tensor_map[next(iter(tids))].data

    def on_net(x):
        if isinstance(x, np.ndarray) and isinstance(ref, torch.Tensor):
            return to_device(x, device=ref.device)
        return x

    if contract is False or (
        contract in ("split-gate", "auto-split-gate") and ng != 2
    ):
        # lazy: add gate tensor, reindex site inds
        reindex_map = {ix: rand_uuid() for ix in inds}
        TG = Tensor(on_net(G),
                    inds=(*inds, *[reindex_map[ix] for ix in inds]),
                    tags=tags)
        for tid in tids:
            t = tn.tensor_map[tid]
            t.reindex_({
                ix: reindex_map[ix] for ix in inds if ix in t.inds
            })
        tn.add_tensor(TG, virtual=True)
        return tn

    if contract in ("split-gate", "auto-split-gate"):
        Gl, Gr, k = gate_split_gate(G, ng, dp)
        if contract == "auto-split-gate" and k >= dp[0] * dp[0]:
            # no benefit — a single lazy gate tensor instead
            return tensor_network_gate_inds(
                tn, G, inds, contract=False, tags=tags, inplace=True,
            )
        bix = rand_uuid()
        new0, new1 = rand_uuid(), rand_uuid()
        t0 = [tn.tensor_map[t] for t in tids if inds[0] in
              tn.tensor_map[t].inds]
        t1 = [tn.tensor_map[t] for t in tids if inds[1] in
              tn.tensor_map[t].inds]
        for t in t0:
            t.reindex_({inds[0]: new0})
        for t in t1:
            t.reindex_({inds[1]: new1})
        tn.add_tensor(Tensor(on_net(Gl), (inds[0], new0, bix), tags),
                      virtual=True)
        tn.add_tensor(Tensor(on_net(Gr), (inds[1], new1, bix), tags),
                      virtual=True)
        return tn

    if contract is True or ng == 1 or len(tids) == 1:
        # contract gate into the (single or joined) site tensors
        reindex_map = {ix: rand_uuid() for ix in inds}
        TG = Tensor(on_net(G),
                    inds=(*inds, *[reindex_map[ix] for ix in inds]))
        ts = [tn._pop_tensor(tid) for tid in tids]
        for t in ts:
            t.reindex_({ix: reindex_map[ix] for ix in inds
                        if ix in t.inds})
        new = tensor_contract(*ts, TG, preserve_tensor=True)
        new.modify(tags=new.tags | tags)
        tn.add_tensor(new, virtual=True)
        return tn

    if ng != 2 or len(tids) != 2:
        raise ValueError(
            f"contract={contract!r} needs exactly 2 indices on 2 "
            f"different tensors"
        )

    tid0, tid1 = tids
    T0, T1 = tn.tensor_map[tid0], tn.tensor_map[tid1]
    if inds[0] not in T0.inds:
        T0, T1 = T1, T0
        tid0, tid1 = tid1, tid0

    bnds = list(bonds(T0, T1))

    if contract == "split" or not bnds:
        # full theta contraction then split
        reindex_map = {ix: rand_uuid() for ix in inds}
        TG = Tensor(on_net(G),
                    inds=(*inds, *[reindex_map[ix] for ix in inds]))
        T0.reindex_({inds[0]: reindex_map[inds[0]]})
        T1.reindex_({inds[1]: reindex_map[inds[1]]})
        theta = tensor_contract(T0, T1, TG, preserve_tensor=True)
        lix = [ix for ix in T0.inds if ix != reindex_map[inds[0]]
               and ix not in bnds] + [inds[0]]
        l, r = theta.split(
            left_inds=lix, get="tensors", absorb="both",
            bond_ind=bnds[0] if bnds else None,
            info=info, **compress_opts,
        )
        l = l.transpose_like_(T0.reindex({reindex_map[inds[0]]: inds[0]}))
        tn._pop_tensor(tid0)
        tn._pop_tensor(tid1)
        l.modify(tags=T0.tags | tags)
        r.modify(tags=T1.tags | tags)
        tn.add_tensor(l, tid=tid0, virtual=True)
        tn.add_tensor(r, tid=tid1, virtual=True)
        return tn

    # reduce-split (the TEBD workhorse)
    # 1. QR both site tensors towards their gated index + bond
    bix = bnds[0]
    l0 = [ix for ix in T0.inds if ix not in (inds[0], bix)]
    l1 = [ix for ix in T1.inds if ix not in (inds[1], bix)]

    Q0, R0 = _qr_towards(T0, l0, (inds[0], bix))
    Q1, R1 = _qr_towards(T1, l1, (inds[1], bix))
    # R0 has inds (q0bond, inds0, bix); R1 has (q1bond, inds1, bix)

    # 2. gate the small cores
    reindex_map = {ix: rand_uuid() for ix in inds}
    TG = Tensor(on_net(G), inds=(*inds, *[reindex_map[ix] for ix in inds]))
    R0.reindex_({inds[0]: reindex_map[inds[0]]})
    R1.reindex_({inds[1]: reindex_map[inds[1]]})
    theta = tensor_contract(R0, R1, TG, preserve_tensor=True)

    # 3. split back
    lix = [ix for ix in R0.inds
           if ix in theta.inds and ix != reindex_map[inds[0]]] + [inds[0]]
    sl, sr = theta.split(
        left_inds=lix, get="tensors", absorb="both", bond_ind=bix,
        info=info, **compress_opts,
    )

    # 4. reabsorb into the environments
    new0 = tensor_contract(Q0, sl, preserve_tensor=True)
    new1 = tensor_contract(Q1, sr, preserve_tensor=True)
    new0.transpose_like_(T0)
    new1.transpose_like_(T1)
    new0.modify(tags=T0.tags | tags)
    new1.modify(tags=T1.tags | tags)
    tn._pop_tensor(tid0)
    tn._pop_tensor(tid1)
    tn.add_tensor(new0, tid=tid0, virtual=True)
    tn.add_tensor(new1, tid=tid1, virtual=True)
    return tn


def _qr_towards(T, other_inds, keep_inds):
    """Split ``T`` into isometric Q (on other_inds) and small core R (on
    keep_inds + new bond), via QR."""
    dq = [T.ind_size(ix) for ix in other_inds]
    dk = [T.ind_size(ix) for ix in keep_inds]
    mat = T.transpose(*other_inds, *keep_inds).data.reshape(
        int(np.prod(dq)) if dq else 1, int(np.prod(dk)) if dk else 1,
    )
    Q, _, R = decomp.qr_stabilized(mat)
    k = Q.shape[-1]
    qbond = rand_uuid()
    TQ = Tensor(Q.reshape(*dq, k), inds=(*other_inds, qbond))
    TR = Tensor(R.reshape(k, *dk), inds=(qbond, *keep_inds))
    return TQ, TR


def tensor_network_gate_sandwich(
    tn, G, upper_inds, lower_inds, **kwargs
):
    """Apply a gate to an operator TN from both sides (op-op gating,
    reference gating.py:642): G acts on upper_inds, G† on lower_inds."""
    tn = tensor_network_gate_inds(tn, G, upper_inds, **kwargs)
    if not isinstance(G, torch.Tensor):
        G = np.asarray(G)
    tn = tensor_network_gate_inds(tn, ar.do_conj(G), lower_inds,
                                  inplace=True, **kwargs)
    return tn


# reference-compatible name (gating.py:642)
tensor_network_gate_sandwich_inds = tensor_network_gate_sandwich
