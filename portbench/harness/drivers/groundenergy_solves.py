"""Back-to-back ground-energy solves of a symmetry-sector operator: the
configuration's lattice and model are built through the program's entry
points into a matrix-free ``CoupledHam`` once, in set-up; a step of the
window is one ``quimb_torch.groundenergy(op, v0=..., tol=...)``.

The start vectors come from a pool of the mix's ``start_pool`` vectors,
the same for every seed, made on the card from their own numbers; the
run's seed sets the order in which the solves take them. How many Lanczos
restarts a solve needs depends on its start (three or four of them at
``tol=1e-10``), so a start of its own for every solve would make the
work of a window change with the seed. With the pool, and a window that
closes only after whole passes over it, every seed does the same set of
solves in another order, however fast the card.

What is judged: each solve's energy against the plain reference's ground
energy of the same sector (``energy_gap``, the largest relative gap).
"""

import importlib

import torch

from portbench.harness.seeds import generator, sub_seed

DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: the seed of the pool of start vectors, the same in every run
POOL_SEED = 0


class Driver:

    def __init__(self, program, config, mix, seed, device):
        self.qt, self.cfg, self.mix = program, config, mix
        self.seed, self.device = seed, torch.device(device)
        self.dtype = DTYPES[mix["dtype"]]
        self.energies = []
        pool = int(mix["start_pool"])
        order = torch.Generator().manual_seed(sub_seed(seed, "order"))
        self.order = torch.randperm(pool, generator=order).tolist()

    def setup(self):
        lat, model = self.cfg["lattice"], self.cfg["model"]
        edges = getattr(self.qt, lat["builder"])(*lat["args"],
                                                 **lat["kwargs"])
        sites = sorted({s for e in edges for s in e})
        operator = importlib.import_module(self.qt.__name__ + ".operator")
        hs = operator.HilbertSpace(sites, symmetry=self.cfg["symmetry"],
                                   sector=self.cfg["sector"])
        builder = getattr(operator, model["builder"])(
            edges, hilbert_space=hs, **model["kwargs"])
        self.op = builder.build_coupled_ham(dtype=self.mix["dtype"],
                                            device=self.device)

    def make_input(self, kind, n=0):
        """The start vector of solve ``n`` of the window (``kind``
        "solve"), or of the warm-up: D standard normal draws in one call."""
        if kind == "solve":
            key = (POOL_SEED, "start", self.order[n % len(self.order)])
        else:
            key = (self.seed, kind, n)
        return torch.randn(int(self.cfg["D"]), dtype=self.dtype,
                           device=self.device,
                           generator=generator(torch, self.device, *key))

    def _solve(self, *key):
        return float(self.qt.groundenergy(self.op, v0=self.make_input(*key),
                                          tol=float(self.cfg["tol"])))

    def warmup(self):
        self._solve("warmup")

    def step(self):
        self.energies.append(self._solve("solve", len(self.energies)))

    def answered(self):
        """The solves the window finished."""
        return len(self.energies)

    def at_boundary(self):
        """Whether the solves so far make whole passes over the pool."""
        return len(self.energies) % len(self.order) == 0

    def instrument(self, spans):
        """A span around every matvec of the sector operator."""
        spans.patch(type(self.op), "matvec", "sector_matvec",
                    record=lambda op, x: (op.shape[0], x.dtype))

    def finish(self):
        del self.op

    def check(self, reference, limits):
        e0 = reference.ground_energy(self.cfg, self.device)
        limit = float(limits["energy_gap"])
        gaps = [abs(e - e0) / abs(e0) for e in self.energies]
        failed = sum(not g <= limit for g in gaps)
        return [("energy_gap", max(gaps, default=float("nan")), limit)], \
            failed
