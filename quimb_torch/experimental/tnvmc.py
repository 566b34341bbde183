"""Variational Monte Carlo on tensor networks.

Port of quimb_tpu's ``experimental/tnvmc.py`` (reference
``quimb/experimental/tnvmc.py``: samplers :96-:596, ``AmplitudeFactory``
:841, stochastic reconfiguration ``SR`` :1316, ``TNVMC`` :1352). Where
quimb_tpu ``vmap``s each hot operation, the port runs one batched program
over the chains:

- amplitudes: each site tensor is gathered at every chain's configuration
  into a stack with a leading batch label, which every pairwise step of
  one fixed contraction expression carries (``ops/contraction.py``'s
  batched ``matmul``);
- gradients: each chain owns its gathered slices, so one backward pass
  of ``sum_c log|psi(c)|`` through them gives every chain's
  ``O_k(c) = d log|psi(c)| / d theta_k``, scattered back to the
  parameters' layout;
- samplers: the Metropolis chains draw their proposals and acceptances
  from a seeded ``torch.Generator`` on the tensors' device (their streams
  cannot match JAX's), and on CUDA a proposal step is captured once as a
  CUDA graph and replayed; the direct samplers (dense, cluster, BP) draw
  from numpy's ``default_rng``, as quimb_tpu's do;
- stochastic reconfiguration: quimb_tpu's formula, its S matrix solved on
  the device.

Host reads follow quimb_tpu's: ``step`` reads the mean energy and its
error once, the sweeps of ``_sample_batch`` read nothing, and
``AmplitudeFactory``'s cache is keyed on host bytes.

Complex parameters: JAX's gradient of a real function of complex inputs is
the conjugate of torch's, so ``_grad_logs`` conjugates torch's gradient
and returns quimb_tpu's ``O`` (the holomorphic log-derivative). quimb_tpu's
update (``O.T @ O`` and ``O (E_loc - E)``) is a descent direction only for
real parameters; ``step`` conjugates ``O`` in the S matrix and the force,
which gives the same update for real parameters and descends for complex
ones (``ROADMAP.md`` §3).
"""

import collections

import numpy as np
import torch

from ..ops.backend import to_device, to_host
from ..utils import LRU, progbar as Progbar

__all__ = [
    "TNVMC", "MetropolisHastingsSampler", "ExchangeSampler",
    "HamiltonianSampler", "DenseSampler", "ClusterSampler",
    "BPSampler", "AmplitudeFactory", "make_amplitude_fn",
]

# host reads by kind ("energy", "energy error"): two a step
HOST_READS = collections.Counter()

#: the label every gathered stack carries: the chain index
_BATCH = "__tnvmc_batch__"


def _psi_sites(psi):
    return list(psi.sites) if hasattr(psi, "sites") else list(range(psi.L))


class _BatchedAmplitude:
    """``fn(params, configs)``: the amplitudes of a TN vector at a batch
    of configurations (or at one, for a 1D ``configs``). Each site tensor
    is gathered at its configuration values into a ``(B, ...)`` stack, and
    one expression, cached per batch size, contracts the stacks."""

    def __init__(self, psi):
        sites = _psi_sites(psi)
        site_pos = {psi.site_ind(s): i for i, s in enumerate(sites)}
        self.tids = list(psi.tensor_map)
        tensors = [psi.tensor_map[t] for t in self.tids]
        self.inputs, self.kept_shapes, self.gathers, self.perms = \
            [], [], [], []
        for t in tensors:
            gax = [(ax, site_pos[ix]) for ax, ix in enumerate(t.inds)
                   if ix in site_pos]
            rest = [ax for ax in range(t.ndim)
                    if ax not in {a for a, _ in gax}]
            self.gathers.append(tuple(sp for _, sp in gax))
            self.perms.append(tuple(a for a, _ in gax) + tuple(rest))
            kept = tuple(t.inds[ax] for ax in rest)
            self.inputs.append(((_BATCH,) + kept) if gax else kept)
            self.kept_shapes.append(tuple(t.shape[ax] for ax in rest))

    def expression(self, nbatch):
        from ..ops.contraction import array_contract_expression

        shapes = [((nbatch,) + ks) if g else ks
                  for ks, g in zip(self.kept_shapes, self.gathers)]
        return array_contract_expression(self.inputs, (_BATCH,),
                                         shapes=shapes)

    def gather(self, params, configs):
        """The ``(B, ...)`` stack of each tensor at ``configs`` (B, nsites)."""
        out = []
        for a, g, perm in zip(params, self.gathers, self.perms):
            if not g:
                out.append(a)
                continue
            ap = a.permute(perm) if perm != tuple(range(a.ndim)) else a
            out.append(ap[tuple(configs[:, sp] for sp in g)])
        return out

    def contract(self, slices, nbatch):
        return self.expression(nbatch)(*slices)

    def scatter(self, grads, params, configs):
        """Per-chain gradients of the gathered slices -> ``(B, size)`` in
        each parameter's own layout, concatenated."""
        B = configs.shape[0]
        rows = torch.arange(B, device=configs.device)
        flat = []
        for gs, a, g, perm in zip(grads, params, self.gathers, self.perms):
            full = torch.zeros((B,) + tuple(a.shape[p] for p in perm),
                               dtype=gs.dtype, device=gs.device)
            full[(rows,) + tuple(configs[:, sp] for sp in g)] = gs
            inv = [0] + [1 + perm.index(ax) for ax in range(a.ndim)]
            flat.append(full.permute(inv).reshape(B, -1))
        return torch.cat(flat, dim=1)

    def __call__(self, params, configs):
        single = configs.ndim == 1
        if single:
            configs = configs[None, :]
        amps = self.contract(self.gather(params, configs), configs.shape[0])
        return amps[0] if single else amps


def make_amplitude_fn(psi):
    """``(fn, params)`` with ``fn(params, configs) -> amplitudes`` for a
    TN vector ``psi`` (one configuration, or a ``(B, nsites)`` batch of
    them, as ``int64`` tensors on the parameters' device)."""
    fn = _BatchedAmplitude(psi)
    return fn, [psi.tensor_map[t].data for t in fn.tids]


def _device_of(params):
    return params[0].device


def _configs_to(configs, device):
    if isinstance(configs, torch.Tensor):
        return configs.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(configs), dtype=torch.int64,
                           device=device)


class AmplitudeFactory:
    """Cached amplitude store (reference ``AmplitudeFactory``
    tnvmc/tnvmc.py:841): wraps :func:`make_amplitude_fn` with an
    LRU-bounded config -> amplitude cache keyed on the configurations'
    host bytes, so repeated queries of the same configuration contract
    nothing. The misses of a batch request go through one batched
    contraction."""

    def __init__(self, psi, maxsize=2**17):
        self.psi = psi
        self._fn, self.params = make_amplitude_fn(psi)
        self._cache = LRU(maxsize=maxsize)

    @staticmethod
    def _key(config):
        return np.asarray(config, dtype=np.int8).tobytes()

    def update(self, params=None, psi=None):
        """New parameters (or a whole new ``psi``): empties the cache
        (reference ``update`` tnvmc/tnvmc.py:1007)."""
        if psi is not None:
            self.psi = psi
            self._fn, self.params = make_amplitude_fn(psi)
        if params is not None:
            self.params = params
        self._cache.clear()

    def amplitudes(self, configs):
        """Batch amplitudes, computing only the cache misses."""
        configs = np.asarray(to_host(configs))
        keys = [self._key(c) for c in configs]
        missing = [i for i, k in enumerate(keys) if k not in self._cache]
        if missing:
            amps = to_host(self._fn(self.params, _configs_to(
                configs[missing], _device_of(self.params))))
            for j, i in enumerate(missing):
                self._cache[keys[i]] = complex(amps[j])
        return np.asarray([self._cache[k] for k in keys])

    def amplitude(self, config):
        return self.amplitudes(np.asarray(config)[None, :])[0]

    def prob(self, config):
        return abs(self.amplitude(config)) ** 2

    def __contains__(self, config):
        return self._key(config) in self._cache

    def __getitem__(self, config):
        return self._cache[self._key(config)]

    def __setitem__(self, config, c):
        self._cache[self._key(config)] = c

    def __repr__(self):
        return (f"<AmplitudeFactory(cached={len(self._cache)}, "
                f"maxsize={self._cache.maxsize})>")


# ---------------------------------------------------------------------------
# samplers: batched Metropolis chains
# ---------------------------------------------------------------------------


class MetropolisHastingsSampler:
    """Parallel single-spin-flip Metropolis chains (reference
    ``MetropolisHastingsSampler`` tnvmc.py:596). The start configurations
    come from ``np.random.default_rng(seed)``, as quimb_tpu's; proposals and
    acceptances from a ``torch.Generator`` seeded ``seed`` on the device the
    chains run on."""

    def __init__(self, nsites, nchains=64, initial=None, seed=0):
        self.nsites = nsites
        self.nchains = nchains
        self.seed = seed
        rng = np.random.default_rng(seed)
        if initial is None:
            initial = rng.integers(0, 2, (nchains, nsites))
        self.configs = torch.as_tensor(np.asarray(initial), dtype=torch.int64)
        self.generator = None

    def _generator(self, device):
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(self.seed)
        return self.generator

    def _randint(self, high, configs):
        return torch.randint(0, high, (configs.shape[0],),
                             generator=self._generator(configs.device),
                             device=configs.device)

    def propose(self, configs):
        sites = self._randint(self.nsites, configs)
        rows = torch.arange(configs.shape[0], device=configs.device)
        flipped = configs.clone()
        flipped[rows, sites] = 1 - configs[rows, sites]
        return flipped


class ExchangeSampler(MetropolisHastingsSampler):
    """Neighbour-exchange proposals in the sites' linear order, which
    conserve the total magnetization (reference ``ExchangeSampler``
    tnvmc.py:522)."""

    def __init__(self, nsites, nchains=64, n_up=None, seed=0):
        if n_up is None:
            n_up = nsites // 2
        rng = np.random.default_rng(seed)
        initial = np.zeros((nchains, nsites), dtype=np.int64)
        for c in range(nchains):
            initial[c, rng.choice(nsites, n_up, replace=False)] = 1
        super().__init__(nsites, nchains, initial, seed)

    def propose(self, configs):
        i = self._randint(self.nsites - 1, configs)
        rows = torch.arange(configs.shape[0], device=configs.device)
        new = configs.clone()
        new[rows, i] = configs[rows, i + 1]
        new[rows, i + 1] = configs[rows, i]
        return new


class HamiltonianSampler(MetropolisHastingsSampler):
    """Moves drawn from the Hamiltonian's off-diagonal flip masks, which
    keep the walkers in the sector the Hamiltonian connects (reference
    hamiltonian sampler tnvmc.py)."""

    def __init__(self, nsites, flip_masks, nchains=64, initial=None,
                 seed=0):
        super().__init__(nsites, nchains=nchains, initial=initial,
                         seed=seed)
        masks = [m for m in flip_masks if np.any(np.asarray(m))]
        if not masks:
            masks = [np.eye(1, nsites, 0, dtype=np.int64)[0]]
        self.flip_masks = torch.as_tensor(np.stack(masks), dtype=torch.int64)

    @classmethod
    def from_ham(cls, ham, nsites, **kwargs):
        masks = []
        for _, _, flip, _ in ham.build_coupling_map():
            masks.append(np.array([(flip >> s) & 1 for s in range(nsites)],
                                  dtype=np.int64))
        return cls(nsites, masks, **kwargs)

    def propose(self, configs):
        # moved to the chains' device once, outside any graph capture
        if self.flip_masks.device != configs.device:
            self.flip_masks = self.flip_masks.to(configs.device)
        idx = self._randint(self.flip_masks.shape[0], configs)
        return torch.bitwise_xor(configs, self.flip_masks[idx])


class DenseSampler:
    """Exact direct sampler from the full dense distribution (small
    systems; reference ``DenseSampler`` tnvmc.py:96). ``sample()`` returns
    one ``(config, omega)`` draw from ``np.random.default_rng(seed)``,
    omega the exact probability of the draw, so the importance weights of
    :meth:`TNVMC._sample_direct` are constant."""

    autocorrelated = False

    def __init__(self, psi=None, nchains=64, seed=0):
        self.rng = np.random.default_rng(seed)
        self.nchains = nchains
        self._psi = None
        if psi is not None:
            self._set_psi(psi)

    def _set_psi(self, psi):
        self._psi = psi
        self.nsites = psi.L if hasattr(psi, "L") else len(psi.sites)
        p = np.abs(to_host(psi.to_dense()).reshape(-1)) ** 2
        self.p = p / p.sum()

    def sample(self):
        i = int(self.rng.choice(self.p.size, p=self.p))
        config = np.array([(i >> (self.nsites - 1 - s)) & 1
                           for s in range(self.nsites)], dtype=np.int64)
        return config, float(self.p[i])

    def sample_batch(self, n):
        """Draw ``n`` iid configurations as a stacked array."""
        return torch.as_tensor(np.stack([self.sample()[0] for _ in range(n)]),
                               dtype=torch.int64)

    def update(self, psi=None, **kwargs):
        if psi is not None:
            self._set_psi(psi)


class ClusterSampler:
    """Direct sampler from local-cluster reduced density matrices
    (reference ``ClusterSampler`` tnvmc/tnvmc.py:364): sites are sampled
    one at a time in a hierarchical order, each from the diagonal of the
    density matrix of a patch of radius ``max_distance`` whose cut
    environment is approximated by simple-update gauges; each sampled site
    is then fixed and the gauges re-converged locally. Returns
    ``(config, omega)``, omega the proposal probability, for importance
    reweighting in :class:`TNVMC`. Draws from ``np.random.default_rng``."""

    autocorrelated = False

    def __init__(self, psi=None, max_distance=1, use_gauges=True,
                 gauge_iterations=3, seed=None, contract_opts=None):
        self.rng = np.random.default_rng(seed)
        self.max_distance = max_distance
        self.use_gauges = use_gauges
        self.gauge_iterations = gauge_iterations
        self.contract_opts = dict(contract_opts or {})
        if psi is not None:
            self._set_psi(psi)

    def _set_psi(self, psi):
        self._psi = psi.copy()
        self.sites = _psi_sites(psi)
        if self.use_gauges:
            # the network held in Vidal form: cutting out a patch later
            # only needs the dangling bonds' gauges reinserted
            self.gauges0 = {}
            self._psi.gauge_all_simple(max_iterations=10, tol=1e-9,
                                       gauges=self.gauges0, inplace=True)
        else:
            self.gauges0 = None
        if hasattr(self._psi, "site_tag"):
            self._site_tag = self._psi.site_tag
        else:
            self._site_tag = lambda s: s
        self.tid2site = {}
        for site in self.sites:
            (tid,) = self._psi._get_tids_from_tags(self._site_tag(site))
            self.tid2site[tid] = site
        self.ordering = self._psi.compute_hierarchical_ordering()

    def sample(self):
        psi = self._psi.copy()
        gauges = dict(self.gauges0) if self.use_gauges else None
        config = {}
        omega = 1.0
        for tid in self.ordering:
            site = self.tid2site.get(tid)
            if site is None:
                continue
            ind = psi.site_ind(site)
            k = psi.select_local(self._site_tag(site),
                                 max_distance=self.max_distance,
                                 virtual=False)
            if gauges is not None:
                k.gauge_simple_insert(gauges)
            rho = (k.H & k).contract(..., output_inds=(ind,),
                                     **self.contract_opts)
            pk = np.abs(to_host(rho.data if hasattr(rho, "data")
                                else rho).real)
            pk = pk / pk.sum()
            idx = int(self.rng.choice(pk.size, p=pk))
            config[site] = idx
            omega *= float(pk[idx])
            psi.isel_({ind: idx})
            if gauges is not None:
                patch = psi.select_local(
                    site, max_distance=self.max_distance + 1, virtual=True)
                patch.gauge_all_simple(max_iterations=self.gauge_iterations,
                                       gauges=gauges, inplace=True)
        return np.asarray([config[s] for s in self.sites],
                          dtype=np.int64), omega

    candidate = sample

    def update(self, psi=None, **kwargs):
        if psi is not None:
            self._set_psi(psi)


class BPSampler:
    """Direct sampler from 2-norm belief-propagation marginals (the role
    of reference ``BPFGSampler`` tnvmc/tnvmc.py:468): ``sample_d2bp`` on
    the vector network, seeded from ``np.random.default_rng(seed)``.
    Returns ``(config, omega)`` for importance reweighting."""

    autocorrelated = False

    def __init__(self, psi=None, seed=None, **bp_opts):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.bp_opts = dict(bp_opts)
        self.bp_opts.setdefault("max_iterations", 100)
        self.bp_opts.setdefault("tol", 1e-6)
        if psi is not None:
            self._set_psi(psi)

    def _set_psi(self, psi):
        self._psi = psi.copy()
        self.sites = _psi_sites(psi)
        self.ind2site = {psi.site_ind(s): s for s in self.sites}

    def sample(self):
        from ..tensor.belief_propagation.d2bp import sample_d2bp

        config, _, omega = sample_d2bp(
            self._psi, output_inds=list(self.ind2site),
            seed=int(self.rng.integers(2**31)), **self.bp_opts)
        bysite = {self.ind2site[ix]: v for ix, v in config.items()}
        return np.asarray([bysite[s] for s in self.sites],
                          dtype=np.int64), float(omega)

    candidate = sample

    def update(self, psi=None, **kwargs):
        if psi is not None:
            self._set_psi(psi)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


class TNVMC:
    """Variational Monte Carlo driver (reference ``TNVMC``
    tnvmc.py:1352), on the device of ``psi``'s tensors.

    Parameters
    ----------
    psi : TN vector (MPS / PEPS / TensorNetworkGenVector)
    ham : SparseOperatorBuilder (sites 0..n-1, in ``psi``'s site order)
    sampler : sampler instance (defaults to Metropolis)
    learning_rate : float
    conditioner : {'sr', 'minsr', 'sgd'}
    """

    #: the most configurations one amplitude contraction takes: the local
    #: energies of all flips go through chunks of this many
    batch_size = 2**13

    def __init__(self, psi, ham, sampler=None, learning_rate=0.05,
                 conditioner="sr", sr_damping=1e-3, nchains=64,
                 burn_in=32, sweeps_per_sample=None, seed=0):
        self.psi = psi.copy()
        self.ham = ham
        self.learning_rate = learning_rate
        self.conditioner = conditioner
        self.sr_damping = sr_damping
        self._graph = None
        self.nsites = psi.L if hasattr(psi, "L") else len(psi.sites)
        self.sweeps_per_sample = sweeps_per_sample or self.nsites
        self.nchains = nchains
        self.sampler = sampler or MetropolisHastingsSampler(
            self.nsites, nchains=nchains, seed=seed)
        self.direct = not getattr(self.sampler, "autocorrelated", True)
        if self.direct and getattr(self.sampler, "_psi", None) is None:
            self.sampler._set_psi(psi)
        self.burn_in = burn_in
        self.energies = []
        self.energy_errors = []

        self._amp_fn, self.params = make_amplitude_fn(self.psi)
        device = _device_of(self.params)
        # per term: the coefficient, the sites, the index of its flip mask
        # among the distinct nonzero ones (-1 for a diagonal term) and its
        # 2x2 tables on the device
        self._coupling = ham.build_coupling_map()
        self._terms = []
        flips = {}
        for coeff, sites, flip, mats in self._coupling:
            k = -1 if flip == 0 else flips.setdefault(flip, len(flips))
            self._terms.append((
                complex(coeff), tuple(sites), k,
                tuple(to_device(np.asarray(M), device=device)
                      for M in mats),
            ))
        self._flip_bits = torch.as_tensor(
            np.array([[(f >> s) & 1 for s in range(self.nsites)]
                      for f in flips], dtype=np.int64).reshape(
                          len(flips), self.nsites), device=device)

    # -- batched computations -----------------------------------------------

    def _configs(self, configs):
        return _configs_to(configs, _device_of(self.params))

    def _log_amp_batch(self, params, configs):
        return self._amp_fn(params, self._configs(configs))

    def _local_energies(self, params, configs):
        """E_loc(c) = sum_terms coeff * prod(M) * psi(c')/psi(c). The
        configurations c' of every distinct flip mask go through one
        batched contraction (in chunks of ``batch_size``); a diagonal
        term's ratio is exactly one."""
        configs = self._configs(configs)
        psi_c = self._log_amp_batch(params, configs)
        dtype = psi_c.dtype
        B, n = configs.shape
        K = self._flip_bits.shape[0]
        if K:
            flipped = torch.bitwise_xor(configs[None, :, :],
                                        self._flip_bits[:, None, :])
            flipped = flipped.reshape(K * B, n)
            amps = torch.cat([
                self._amp_fn(params, flipped[i:i + self.batch_size])
                for i in range(0, K * B, self.batch_size)])
            ratios = amps.reshape(K, B) / psi_c
        e = torch.zeros(B, dtype=dtype, device=configs.device)
        for coeff, sites, k, mats in self._terms:
            amp_fac = torch.full((B,), coeff if dtype.is_complex
                                 else coeff.real, dtype=dtype,
                                 device=configs.device)
            new_configs = configs if k < 0 else flipped[k * B:(k + 1) * B]
            for s, M in zip(sites, mats):
                Mj = (M if dtype.is_complex else M.real).to(dtype)
                amp_fac = amp_fac * Mj[new_configs[:, s], configs[:, s]]
            e = e + (amp_fac if k < 0 else amp_fac * ratios[k])
        return e

    def _mh_step(self, params, configs, p, gen):
        """One Metropolis-Hastings proposal and acceptance for every chain:
        the new configurations and their |psi|^2."""
        prop = self.sampler.propose(configs)
        p_new = torch.abs(self._amp_fn(params, prop)) ** 2
        u = torch.rand(configs.shape[0], generator=gen, dtype=p.dtype,
                       device=configs.device)
        accept = u * p < p_new
        return (torch.where(accept[:, None], prop, configs),
                torch.where(accept, p_new, p))

    def _sample_batch(self, params, n_sweeps):
        """Advance all chains ``n_sweeps`` proposal steps, on the device,
        with no host read. On CUDA the first step runs eagerly and the rest
        replay one captured CUDA graph of a step (some 200 small launches):
        the same operations, launched at once."""
        configs = self._configs(self.sampler.configs)
        gen = self.sampler._generator(configs.device)
        p = torch.abs(self._log_amp_batch(params, configs)) ** 2
        if n_sweeps > 0 and configs.is_cuda:
            configs, p = self._mh_step(params, configs, p, gen)
            configs = self._replay_steps(params, configs, p, gen,
                                         n_sweeps - 1)
        else:
            for _ in range(n_sweeps):
                configs, p = self._mh_step(params, configs, p, gen)
        self.sampler.configs = configs
        return configs

    def _replay_steps(self, params, configs, p, gen, n):
        """``n`` more steps as replays of the captured step, which reads
        the parameters, chains and weights from static buffers and writes
        the chains and weights back into them. Captured once for each
        sampler, generator and chain count: the cache holds the objects
        themselves, so a new sampler never replays an old one's graph."""
        shape = tuple(configs.shape)
        if (self._graph is None or self._graph[0] is not self.sampler
                or self._graph[1] is not gen or self._graph[2] != shape):
            bufs = [x.detach().clone() for x in params]
            c_in, p_in = configs.clone(), p.clone()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            with torch.cuda.graph(graph):
                c_out, p_out = self._mh_step(bufs, c_in, p_in, gen)
                c_in.copy_(c_out)
                p_in.copy_(p_out)
            self._graph = (self.sampler, gen, shape, graph, bufs, c_in,
                           p_in)
        graph, bufs, c_in, p_in = self._graph[3:]
        for b, x in zip(bufs, params):
            b.copy_(x)
        c_in.copy_(configs)
        p_in.copy_(p)
        for _ in range(n):
            graph.replay()
        return c_in.clone()

    def _grad_logs(self, params, configs):
        """O_k(c) = d log|psi(c)| / d theta_k, per chain, flattened in
        each parameter's layout: one backward pass through the chains'
        gathered slices. Complex parameters get JAX's convention (the
        conjugate of torch's gradient), as quimb_tpu's ``vmap(grad)``."""
        configs = self._configs(configs)
        slices = [s.detach().requires_grad_(True)
                  for s in self._amp_fn.gather(
                      [p.detach() for p in params], configs)]
        amps = self._amp_fn.contract(slices, configs.shape[0])
        loss = torch.log(torch.abs(amps) + 1e-300).sum()
        grads = torch.autograd.grad(loss, slices)
        O = self._amp_fn.scatter(grads, params, configs)
        return torch.conj_physical(O) if O.is_complex() else O

    def _sample_direct(self, params):
        """``nchains`` independent samples from a direct sampler, with the
        importance weights w(c) = |psi(c)|^2 / omega(c) that make the
        proposal-distribution averages exact (reference sample_fn/omega
        reweighting, tnvmc/tnvmc.py:1417)."""
        configs, omegas = [], []
        for _ in range(self.nchains):
            c, om = self.sampler.sample()
            configs.append(np.asarray(c))
            omegas.append(max(float(om), 1e-300))
        configs = self._configs(np.stack(configs))
        amps = self._log_amp_batch(params, configs)
        p = torch.abs(amps) ** 2
        w = p / torch.as_tensor(omegas, dtype=p.dtype, device=p.device)
        return configs, w / torch.mean(w)

    def _update(self, params, configs, w):
        """The gradient / SR update from ``configs`` and their weights
        (quimb_tpu's, with ``O`` conjugated for complex parameters): the new
        parameters and the mean energy and its error, both still on the
        device."""
        n = configs.shape[0]
        e_loc = self._local_energies(params, configs)
        e_re = e_loc.real if e_loc.is_complex() else e_loc
        e_mean = torch.mean(w * e_re)
        e_err = torch.std(e_re, correction=0) / np.sqrt(n)

        O = self._grad_logs(params, configs)
        Om = O - torch.mean(w[:, None] * O, dim=0, keepdim=True)
        Om = torch.sqrt(w)[:, None] * Om
        dE = torch.sqrt(w) * (e_re - e_mean)
        # the left factor of S and of the force: quimb_tpu's O for real
        # parameters, its conjugate (with the whole complex local energy)
        # for complex ones, where quimb_tpu's O.T @ O is no descent
        Ob = Om
        if Om.is_complex():
            Ob = Om.conj()
            dE = torch.sqrt(w) * (e_loc - e_mean)
        grad_flat = 2 * torch.mean(Ob * dE[:, None], dim=0)

        if self.conditioner == "sr":
            S = (Ob.T @ Om) / n
            S = S + self.sr_damping * torch.eye(
                S.shape[0], dtype=S.dtype, device=S.device)
            delta = torch.linalg.solve_ex(S, grad_flat)[0]
        elif self.conditioner == "minsr":
            # MinSR (reference tnvmc.py:1162, Chen & Heyl): the
            # push-through identity (O'O/n + l)^-1 O' = O' (OO'/n + l)^-1
            # gives an (n, n) solve instead of (nparams, nparams)
            T = (Om @ Ob.T) / n + self.sr_damping * torch.eye(
                n, dtype=Om.dtype, device=Om.device)
            delta = (2.0 / n) * (Ob.T @ torch.linalg.solve_ex(
                T, dE.to(Om.dtype))[0])
        else:
            delta = grad_flat

        new_params = []
        i = 0
        for p in params:
            d = delta[i:i + p.numel()].reshape(p.shape)
            if d.is_complex() and not p.is_complex():
                d = d.real
            new_params.append(p - self.learning_rate * d.to(p.dtype))
            i += p.numel()
        return new_params, e_mean, e_err

    def step(self):
        """One VMC update step. Returns (energy, error)."""
        params = self.params
        if self.direct:
            configs, w = self._sample_direct(params)
        else:
            configs = self._sample_batch(params, self.sweeps_per_sample)
            w = torch.ones(configs.shape[0], dtype=torch.float64,
                           device=configs.device)
        self.params, e_mean, e_err = self._update(params, configs, w)
        if self.direct:
            # direct samplers condition on psi itself: refresh their view
            # (gauges / BP messages) with the updated parameters
            self.sampler.update(psi=self.get_state())
        e_mean, e_err = float(e_mean), float(e_err)
        HOST_READS["energy"] += 1
        HOST_READS["energy error"] += 1
        self.energies.append(e_mean)
        self.energy_errors.append(e_err)
        return e_mean, e_err

    def run(self, steps, progbar=True, burn_in=None):
        """Run VMC optimization."""
        # burn in the chains (direct samplers have no autocorrelation and
        # need none)
        if not self.direct:
            self._sample_batch(self.params, burn_in if burn_in is not None
                               else self.burn_in)
        pbar = Progbar(total=steps) if progbar else None
        for _ in range(steps):
            e, err = self.step()
            if pbar is not None:
                pbar.update()
                pbar.set_description(f"{e:+.6f}({err:.1g})")
        if pbar is not None:
            pbar.close()
        return self

    @property
    def energy(self):
        return self.energies[-1] if self.energies else None

    def get_state(self):
        """The current optimized TN."""
        psi = self.psi.copy()
        for t, p in zip(psi.tensor_map.values(), self.params):
            t.modify(data=p)
        return psi
