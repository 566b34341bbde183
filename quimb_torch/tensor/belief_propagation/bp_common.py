"""Shared belief-propagation machinery (reference
``BeliefPropagationCommon`` bp_common.py:16: damping, update schedules,
convergence via max message difference).

Port of quimb_tpu's ``tensor/belief_propagation/bp_common.py``. Messages
are tensors on the device of the network's tensors. The convergence
distance of a message pair is read to the host (:func:`_distance`, one
read per message), as in quimb_tpu.
"""

import math

import torch


def _network_device(tn):
    """The device of a network's tensors (the CPU for an empty one)."""
    for t in tn.tensor_map.values():
        return t.data.device
    return torch.device("cpu")


def _network_dtype(tn):
    """The torch dtype of a network's tensors."""
    return next(iter(tn.tensor_map.values())).data.dtype


def _distance(ma, mb):
    """Max-abs difference of two (normalized) messages, read to the
    host."""
    return float(torch.max(torch.abs(ma - mb)))


def normalize_message(m):
    nrm = torch.sum(torch.abs(m))
    return torch.where(nrm > 0, m / nrm, m)


def initialize_messages(tn, dtype=None):
    """Uniform initial messages: for every (index, tensor id) pair of an
    index shared by two or more tensors, a ones-vector over that index
    divided by its size."""
    messages = {}
    if not tn.tensor_map:
        return messages
    device = _network_device(tn)
    dtype = dtype or _network_dtype(tn)
    for ix, tids in tn.ind_map.items():
        if len(tids) < 2:
            continue
        d = tn.ind_size(ix)
        for tid in tids:
            messages[ix, tid] = torch.ones(
                (d,), dtype=dtype, device=device) / d
    return messages


class BeliefPropagationCommon:
    """Base: run the iteration loop with damping and convergence
    checking (reference ``BeliefPropagationCommon`` bp_common.py:16)."""

    def __init__(self, tn, damping=0.0, update="sequential",
                 normalize=None, distance=None,
                 tol=5e-6, max_iterations=1000):
        self.tn = tn
        self.damping = damping
        self.update = update
        self.normalize = normalize
        self.distance = distance
        self.tol = tol
        self.max_iterations = max_iterations
        self.n_iter = 0
        self.converged = False
        self.mdiffs = []

    @property
    def damping(self):
        """Damping factor (or callable) mixing old and new messages
        (reference bp_common.py:106)."""
        return self._damping

    @damping.setter
    def damping(self, damping):
        if not callable(damping) and not (0.0 <= damping < 1.0):
            raise ValueError("damping must be in [0, 1)")
        self._damping = damping

    @property
    def normalize(self):
        """How messages are normalized: None (default L1), 'L2', or a
        callable (reference bp_common.py:129)."""
        return self._normalize_setting

    @normalize.setter
    def normalize(self, normalize):
        self._normalize_setting = normalize

    @property
    def distance(self):
        """How message convergence distance is measured: None (default
        max-abs) or a callable (reference bp_common.py:180)."""
        return self._distance_fn

    @distance.setter
    def distance(self, distance):
        self._distance_fn = distance

    @property
    def mdiff(self):
        """The most recent maximum message difference (reference
        ``mdiff`` bp_common.py:403)."""
        return self.mdiffs[-1] if self.mdiffs else float("nan")

    def iterate(self, tol=None):
        raise NotImplementedError

    def contract(self, strip_exponent=False, **kwargs):
        """Estimate the contraction value from the current messages
        (reference bp_common.py:423). Implemented by each BP
        variant."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement contract"
        )

    def plot(self, **kwargs):
        """Plot the message-convergence history (reference
        ``plot`` bp_common.py:384)."""
        from ...utils_plot import plot_multi_series_zoom

        return plot_multi_series_zoom({"mdiff": self.mdiffs}, **kwargs)

    def run(self, max_iterations=None, tol=None, progbar=False):
        max_iterations = max_iterations or self.max_iterations
        tol = tol or self.tol
        for _ in range(max_iterations):
            max_dm = self.iterate(tol=tol)
            self.n_iter += 1
            self.mdiffs.append(max_dm)
            if max_dm < tol:
                self.converged = True
                break
        return self


def initialize_hyper_messages(tn, fill_fn=None, smudge_factor=1e-12):
    """Initial messages for hyper BP: one vector per (index, tensor)
    slot, including hyper indices (reference
    ``initialize_hyper_messages`` bp_common.py:436). A ``fill_fn``'s host
    arrays go to the network's device."""
    from ...ops.backend import to_device

    messages = {}
    if not tn.tensor_map:
        return messages
    device = _network_device(tn)
    dtype = _network_dtype(tn)
    for ix, tids in tn.ind_map.items():
        if len(tids) < 2:
            continue
        d = tn.ind_size(ix)
        for tid in tids:
            if fill_fn is not None:
                m = to_device(fill_fn((d,)), device=device)
            else:
                m = torch.ones((d,), dtype=dtype, device=device)
            messages[ix, tid] = m / torch.sum(torch.abs(m))
    return messages


def combine_local_contractions(zvals, strip_exponent=False,
                               check_zero=True, mantissa=None,
                               exponent=None):
    """Combine local contraction values ``(value, power)`` into a
    single result with exponent stripping (reference
    ``combine_local_contractions`` bp_common.py:494)."""
    m = 1.0 if mantissa is None else mantissa
    e = 0.0 if exponent is None else exponent
    for z, power in zvals:
        z = complex(z)
        if check_zero and z == 0:
            return (0.0, 0.0) if strip_exponent else 0.0
        a = abs(z)
        m = m * (z / a) ** power
        e = e + power * math.log10(a)
    if strip_exponent:
        return m, e
    return m * 10.0**e
