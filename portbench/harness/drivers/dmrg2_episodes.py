"""DMRG2 episodes on an MPO chain: each episode is a fresh random MPS, made on
the card from the run's seed and the episode's number, and a fixed number
of alternating sweeps of ``quimb_torch.DMRG2`` at the configuration's bond
dimension and cutoff. A step of the window is one sweep; an episode's
start (the random state and the engine) belongs to its first sweep. The
window closes only at the end of an episode, so every run does whole
episodes, and the share of episode starts in its sweeps is fixed.

What is judged, for every episode of the window: the energy its last
sweep reports against the plain reference's energy of the state that
sweep left (``energy_gap``), and that state's energy against the
configuration's ``E_REF`` (``e_ref_gap``).
"""

import math

import torch

from portbench.harness.seeds import generator

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "complex64": torch.complex64, "complex128": torch.complex128}


def state_arrays(psi):
    """The site arrays of an open MPS as ``(l, p, r)`` tensors, the chain's
    ends padded with size-1 bonds, read by index names."""
    L = psi.L
    out = []
    for i in range(L):
        inds = ([psi.bond(i - 1, i)] if i > 0 else []) + [psi.site_ind(i)] \
            + ([psi.bond(i, i + 1)] if i < L - 1 else [])
        a = psi[psi.site_tag(i)].transpose(*inds).data
        if i == 0:
            a = a[None]
        if i == L - 1:
            a = a[..., None]
        out.append(a)
    return out


class Driver:

    def __init__(self, program, config, mix, seed, device):
        self.qt, self.cfg, self.mix = program, config, mix
        self.seed, self.device = seed, torch.device(device)
        self.dtype = DTYPES[mix["dtype"]]
        self.chi, self.cutoff = int(config["max_bond"]), float(
            config["cutoff"])
        self.nsweeps = int(mix["sweeps_per_episode"])
        self.sequence = mix["sweep_sequence"]
        #: the running episode: its engine and the energies of its sweeps
        self.current = None
        #: each finished episode's last state and energy
        self.outputs = []
        self.spans = None
        self.sandwich = None

    # -- inputs ---------------------------------------------------------------

    def make_input(self, *key):
        """A random MPS of bond ``chi`` (less at the chain's ends), its
        entries standard normal (complex normal for a complex dtype) over
        ``sqrt(l p)``, drawn in one call on the card."""
        L, d = int(self.cfg["L"]), 2
        dims = [min(self.chi, d**i, d ** (L - i)) for i in range(L + 1)]
        sizes = [dims[i] * d * dims[i + 1] for i in range(L)]
        flat = torch.randn(sum(sizes), dtype=self.dtype, device=self.device,
                           generator=generator(torch, self.device, self.seed,
                                               *key))
        arrays, at = [], 0
        for i, n in enumerate(sizes):
            a = flat[at:at + n].view(dims[i], d, dims[i + 1])
            a = a / math.sqrt(dims[i] * d)
            at += n
            # the program's "lrp" layout, the ends without their missing bond
            if i == 0:
                a = a[0].transpose(0, 1)
            elif i == L - 1:
                a = a[..., 0]
            else:
                a = a.permute(0, 2, 1)
            arrays.append(a)
        return self.qt.MatrixProductState(arrays, shape="lrp")

    # -- the program ----------------------------------------------------------

    def setup(self):
        b = self.cfg["program"]
        self.H = getattr(self.qt, b["builder"])(
            *b["args"], **b["kwargs"], dtype=self.dtype, device=self.device)

    def _engine(self, *key):
        d = self.qt.DMRG2(self.H, bond_dims=self.chi, cutoffs=self.cutoff,
                          p0=self.make_input(*key))
        d.opts.update(self.cfg["opts"])
        if self.sandwich is not None:
            d._sandwich = self.sandwich(d._sandwich)
        if self.spans is not None:
            d._sandwich = self._wrap_prepare(d._sandwich)
        return d

    def _sweep(self, d, s):
        return d.sweep(self.sequence[s % len(self.sequence)],
                       max_bond=self.chi, cutoff=self.cutoff,
                       canonize=s == 0)

    def warmup(self):
        """An episode's start and its first two sweeps: every shape the
        window's sweeps use."""
        d = self._engine("warmup")
        for s in range(min(2, self.nsweeps)):
            self._sweep(d, s)

    def step(self):
        if self.current is None:
            self.current = (self._engine("episode", len(self.outputs)), [])
        d, energies = self.current
        energies.append(self._sweep(d, len(energies)))
        if len(energies) == self.nsweeps:
            self.outputs.append((d.state, energies[-1]))
            self.current = None

    def answered(self):
        """The episodes the window finished."""
        return len(self.outputs)

    def at_boundary(self):
        """Whether the last step ended an episode."""
        return self.current is None

    # -- spans ----------------------------------------------------------------

    def instrument(self, spans):
        """Spans around the local solve, the split and each matvec of the
        sandwich that every engine resolves when it is built, the running
        episode's engine included."""
        from quimb_torch.tensor.tn1d import dmrg

        self.spans = spans
        spans.patch(dmrg, "_local_solve_2site", "local_solve")
        spans.patch(dmrg, "_split_2site", "split")
        if self.current is not None:
            d = self.current[0]
            d._sandwich = self._wrap_prepare(d._sandwich)

    def _wrap_prepare(self, prepare):
        spans = self.spans

        def prepared(a, b):
            dims = (tuple(a.shape), tuple(b.shape), a.dtype)
            return spans.wrap("sandwich", prepare(a, b),
                              record=lambda theta: dims)

        return prepared

    # -- the check --------------------------------------------------------------

    def finish(self):
        """Free the program's objects but the finished episodes' states."""
        self.current = None
        del self.H

    def check(self, reference, limits):
        """``[(name, value, limit), ...]``, each value the largest over the
        episodes, and the number of episodes that failed a limit."""
        e_ref = float(self.cfg["E_REF"])
        gap_limit = float(limits["energy_gap"])
        ref_limit = float(limits["e_ref_gap"])
        gaps, ref_gaps, failed = [], [], 0
        for psi, reported in self.outputs:
            e = reference.energy(state_arrays(psi), self.cfg)
            gaps.append(abs(reported - e) / abs(e))
            ref_gaps.append(abs(e - e_ref) / abs(e_ref))
            failed += not (gaps[-1] <= gap_limit
                           and ref_gaps[-1] <= ref_limit)
        nan = float("nan")
        return [("energy_gap", max(gaps, default=nan), gap_limit),
                ("e_ref_gap", max(ref_gaps, default=nan), ref_limit)], failed
