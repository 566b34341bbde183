"""HV1BP: hyper, vectorized 1-norm belief propagation
(reference ``hv1bp.py``, 1193 LoC: batches all same-shape message updates
into single array ops).

Port of quimb_tpu's ``tensor/belief_propagation/hv1bp.py``. The tensors
are grouped by shape; each group's message updates run as one batched
``torch.einsum`` per leg over the stacked tensors and their gathered
incoming messages, on the device of the network's tensors. The incoming
message of every slot is one gather and one product over the slots of the
other tensors on its index, and the new messages return to their slots by
index tensors fixed at construction. An iteration reads one number to the
host: the largest message change.

A leg whose index no other tensor holds (an open index) receives a
message of ones, so the leg is summed over, as D1BP sums it; quimb_tpu
gathers the last slot's message there instead (ROADMAP §3).
"""

import collections
import math

import numpy as np
import torch

from .bp_common import BeliefPropagationCommon, _network_device


def _padded(rows, fill):
    """``rows`` (lists of ints) as a rectangular int64 array, short rows
    padded with ``fill``."""
    width = max((len(r) for r in rows), default=0) or 1
    out = np.full((len(rows), width), fill, dtype=np.int64)
    for k, r in enumerate(rows):
        out[k, :len(r)] = r
    return out


class HV1BP(BeliefPropagationCommon):
    """Vectorized 1-norm BP with batched message updates."""

    def __init__(self, tn, messages=None, damping=0.0, smudge_factor=1e-12,
                 update="parallel", tol=5e-6, max_iterations=1000):
        super().__init__(tn, damping=damping, update=update, tol=tol,
                         max_iterations=max_iterations)
        self.smudge_factor = smudge_factor
        self._build_batches(messages)

    def _build_batches(self, messages):
        tn = self.tn
        device = _network_device(tn)
        # message M[k] of slot k = (tid, ix) is the message sent by tensor
        # tid along ix; the incoming message of a slot is the product of
        # the messages of the other tensors on ix
        self.slots = []
        slot_id = {}
        for ix, tids in tn.ind_map.items():
            if len(tids) < 2:
                continue
            for tid in tids:
                slot_id[(tid, ix)] = len(self.slots)
                self.slots.append((tid, ix))
        self.slot_id = slot_id

        d_check = {tn.ind_size(ix) for (_, ix) in self.slots}
        if len(d_check) > 1:
            raise ValueError(
                "HV1BP requires uniform bond dimension; use D1BP"
            )
        self.d = d_check.pop() if d_check else 1
        n_slots = len(self.slots)
        # row n_slots of a padded message table is ones: the padding of
        # a gather, and the message of an open leg
        self._ones_row = n_slots

        self.sources = [
            [slot_id[(otid, ix)] for otid in tn.ind_map[ix] if otid != tid]
            for (tid, ix) in self.slots
        ]
        self.src_idx = torch.as_tensor(
            _padded(self.sources, n_slots), device=device)

        # the slots of each index with messages, in the order of the
        # slots, for the index terms of the Bethe estimate
        ind_slots = collections.defaultdict(list)
        for k, (tid, ix) in enumerate(self.slots):
            ind_slots[ix].append(k)
        self._ind_degrees = [len(v) for v in ind_slots.values()]
        self._ind_idx = torch.as_tensor(
            _padded(list(ind_slots.values()), n_slots), device=device)

        # group tensors by shape for batched updates
        groups = collections.defaultdict(list)
        for tid, t in tn.tensor_map.items():
            groups[t.shape].append(tid)
        self.groups = []
        for shape, tids in groups.items():
            stack = torch.stack([tn.tensor_map[t].data for t in tids])
            out_slots = np.full((len(tids), len(shape)), -1, dtype=np.int64)
            for bi, tid in enumerate(tids):
                for li, ix in enumerate(tn.tensor_map[tid].inds):
                    out_slots[bi, li] = slot_id.get((tid, ix), -1)
            slots = torch.as_tensor(out_slots, device=device)
            flat = out_slots.reshape(-1)
            valid = np.flatnonzero(flat >= 0)
            self.groups.append({
                "shape": shape,
                "tids": tids,
                "stack": stack,
                "slots": slots,
                # where each leg's incoming message is gathered from
                "gather": torch.where(slots >= 0, slots, n_slots),
                # which of the group's (tensor, leg) outputs are messages,
                # and their slots: fixed, so the scatter reads nothing back
                "out_rows": torch.as_tensor(valid, device=device),
                "out_slots": torch.as_tensor(flat[valid], device=device),
            })

        dtype = next(iter(tn.tensor_map.values())).data.dtype
        if messages is None:
            M = torch.ones((n_slots, self.d), dtype=dtype,
                           device=device) / self.d
        else:
            M = torch.stack([messages[ix, tid] for (tid, ix) in self.slots])
        self.M = M

    def _with_ones(self, M):
        return torch.cat([M, torch.ones_like(M[:1])])

    def _incoming(self, M):
        """Incoming message for every slot, and a final row of ones: the
        product over source slots (one gather, padding gathering ones)."""
        return self._with_ones(torch.prod(self._with_ones(M)[self.src_idx],
                                          dim=1))

    @staticmethod
    def _leg_messages(stack, incs, li):
        """For each tensor of the batch ``stack`` (B, *shape), the tensor
        contracted with ``incs`` (B, r, d) on every leg but ``li``: one
        batched einsum, (B, d)."""
        r = stack.ndim - 1
        ops = [stack, list(range(r + 1))]
        for lj in range(r):
            if lj != li:
                ops += [incs[:, lj], [0, lj + 1]]
        return torch.einsum(*ops, [0] if li is None else [0, li + 1])

    def iterate(self, tol=5e-6):
        M = self.M
        inc = self._incoming(M)
        new_M = M.clone()
        for g in self.groups:
            r = len(g["shape"])
            if r == 0:
                # rank-0 tensors (e.g. fully-fixed clauses during
                # sampling) emit no messages
                continue
            incs = inc[g["gather"]]  # (B, r, d)
            outs = []
            for li in range(r):
                out = self._leg_messages(g["stack"], incs, li)
                nrm = torch.sum(torch.abs(out), dim=1, keepdim=True)
                outs.append(torch.where(nrm > 0, out / nrm, out))
            outs = torch.stack(outs, dim=1).reshape(-1, self.d)
            new_M[g["out_slots"]] = outs[g["out_rows"]]
        if self.damping:
            new_M = (1 - self.damping) * new_M + self.damping * M
            new_M = new_M / torch.sum(torch.abs(new_M), dim=1, keepdim=True)
        max_dm = float(torch.max(torch.abs(new_M - M)))
        self.M = new_M
        return max_dm

    def get_messages(self):
        return {
            (ix, tid): self.M[k]
            for k, (tid, ix) in enumerate(self.slots)
        }

    def contract(self, strip_exponent=False):
        """Bethe estimate (same formula as D1BP, computed batched: each
        group's local values and all index values reach the host in one
        read each)."""
        inc = self._incoming(self.M)
        mantissa, exponent = 1.0, 0.0
        for g in self.groups:
            zs = self._leg_messages(g["stack"], inc[g["gather"]], None)
            for z in zs.cpu().tolist():
                z = complex(z)
                if z != 0:
                    exponent += math.log10(abs(z))
                    mantissa *= z / abs(z)
        # index corrections
        zixs = torch.sum(torch.prod(self._with_ones(self.M)[self._ind_idx],
                                    dim=1), dim=1)
        for zix, deg in zip(zixs.cpu().tolist(), self._ind_degrees):
            zix = complex(zix)
            if zix != 0:
                dm1 = deg - 1
                exponent -= dm1 * math.log10(abs(zix))
                mantissa /= (zix / abs(zix)) ** dm1
        if strip_exponent:
            return mantissa, exponent
        return mantissa * 10**exponent


def contract_hv1bp(tn, max_iterations=1000, tol=5e-6, damping=0.0,
                   strip_exponent=False, **kwargs):
    """Estimate a TN contraction via vectorized BP."""
    bp = HV1BP(tn, damping=damping, tol=tol,
               max_iterations=max_iterations, **kwargs)
    bp.run()
    return bp.contract(strip_exponent=strip_exponent)


def sample_hv1bp(tn, messages=None, output_inds=None,
                 max_iterations=1000, tol=1e-2, damping=0.0, seed=None,
                 bias=None, progbar=False, **kwargs):
    """Sample a configuration using vectorized hyper 1-norm BP
    (reference ``sample_hv1bp`` hv1bp.py:1012): converge batched
    messages, fix the most decided variable index, repeat. The draws
    come from ``np.random.default_rng(seed)``, as in quimb_tpu. Returns
    ``(config, tn_config, omega)``."""
    from .bp_common import initialize_messages
    from .d1bp import D1BP, _d1bp_marginal, _fix_most_decided

    rng = np.random.default_rng(seed)
    tn = tn.copy()
    if output_inds is None:
        # default: sample every index (for a closed hyper TN each
        # index is one classical variable)
        output_inds = set(tn.ind_map)
    remaining = set(output_inds)
    config = {}
    omega = 1.0

    while remaining:
        if initialize_messages(tn):
            bp = HV1BP(tn, messages=messages, damping=damping,
                       max_iterations=max_iterations, tol=tol,
                       **kwargs)
            bp.run()
            msgs = bp.get_messages()
        else:
            # nothing left to propagate: marginals are direct
            msgs = {}
        # unbatch the converged messages and reuse the (hyper-aware)
        # vector-message marginal of D1BP
        flat = D1BP(tn, messages=msgs)
        marginals = {ix: _d1bp_marginal(flat, ix) for ix in remaining}
        ix, v, pv = _fix_most_decided(marginals, rng, bias)
        config[ix] = v
        omega *= pv
        tn.isel_({ix: v})
        remaining.discard(ix)
        messages = None  # shapes changed, re-initialize
    return config, tn, omega
