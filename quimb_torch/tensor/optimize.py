"""Gradient-based optimization of tensor networks.

Port of quimb_tpu's ``tensor/optimize.py`` (reference
``quimb/tensor/optimize.py``: ``TNOptimizer`` :1171, ``Vectorizer`` :87,
the scipy drivers :1526, :1560). The loss is a function of a network
rebuilt from the parameter tensors; one ``torch.autograd.grad`` of its
real part gives every parameter's gradient, and the parameters stay on
their device. Two kinds of driver:

- the first-order rules of quimb_tpu's optax list ('adam', 'sgd',
  'rmsprop', 'adabelief', 'adagrad', 'nadam', 'adamw', 'lamb', 'lion',
  'novograd', 'yogi'), written here as plain tensor updates from optax
  0.2.6's definitions, defaults included. ``torch.optim`` differs from
  optax on complex parameters (its Adam keeps a second moment per real
  and imaginary part, optax keeps ``|g|^2``), so no rule goes through it;
- the scipy drivers (any ``scipy.optimize.minimize`` method, and
  basin-hopping): the :class:`Vectorizer` takes the parameters to one
  flat float64 host vector per evaluation, as quimb_tpu's do.

For a complex parameter ``z = x + iy`` torch's gradient of a real loss is
``df/dx + i df/dy``, the packed real gradient itself; quimb_tpu conjugates
JAX's gradient to reach the same thing, so the port does not conjugate.
"""

import math

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..utils import progbar as Progbar
from . import interface  # noqa: F401  (registers the network classes)


def _sorted_dict(tree):
    """A dict in JAX's leaf order (sorted keys, where they sort)."""
    if isinstance(tree, dict):
        try:
            return {k: tree[k] for k in sorted(tree)}
        except TypeError:
            return dict(tree)
    return tree


class Vectorizer:
    """Flatten a pytree of (possibly complex) tensors to one real float64
    host vector and back (reference ``Vectorizer`` optimize.py:87); a
    complex leaf packs its real parts, then its imaginary parts."""

    def __init__(self, tree):
        leaves, self.treedef = pytree.tree_flatten(_sorted_dict(tree))
        self.shapes = [tuple(x.shape) for x in leaves]
        self.iscomplex = [x.is_complex() for x in leaves]
        self.dtypes = [x.dtype for x in leaves]
        self.device = leaves[0].device if leaves else torch.device("cpu")
        self.sizes = [math.prod(s) * (2 if c else 1)
                      for s, c in zip(self.shapes, self.iscomplex)]
        self.d = sum(self.sizes)

    def pack(self, tree):
        leaves = pytree.tree_leaves(_sorted_dict(tree))
        if not leaves:
            return np.zeros(0)
        chunks = [(torch.view_as_real(x.detach()).movedim(-1, 0)
                   if x.is_complex() else x.detach()).reshape(-1)
                  .to(torch.float64) for x in leaves]
        return torch.cat(chunks).cpu().numpy()

    def unpack(self, vector):
        v = torch.as_tensor(np.asarray(vector, dtype=np.float64),
                            device=self.device)
        out, i = [], 0
        for shape, c, dt in zip(self.shapes, self.iscomplex, self.dtypes):
            n = math.prod(shape)
            if c:
                x = torch.complex(v[i:i + n], v[i + n:i + 2 * n])
                i += 2 * n
            else:
                x = v[i:i + n]
                i += n
            out.append(x.reshape(shape).to(dt))
        return pytree.tree_unflatten(out, self.treedef)


def parse_network_to_backend(tn, tags=None, shared_tags=None,
                             constant_tags=None):
    """Split a network into its variable parameters and a constant
    skeleton (reference ``parse_network_to_backend`` optimize.py:296).

    Returns ``(params, build_fn)``: ``params`` a dict ``{key: tensor}``
    and ``build_fn(params)`` the whole network. All tensors with one of
    ``shared_tags`` share one parameter."""
    tn = tn.copy()
    constant_tids = set()
    if constant_tags is not None:
        for tag in ((constant_tags,) if isinstance(constant_tags, str)
                    else constant_tags):
            constant_tids |= set(tn.tag_map.get(tag, ()))
    if tags is None:
        var_tids = [t for t in tn.tensor_map if t not in constant_tids]
    else:
        var_tids = [t for t in tn._get_tids_from_tags(tags, "any")
                    if t not in constant_tids]

    shared_groups = {}
    if shared_tags:
        if isinstance(shared_tags, str):
            shared_tags = (shared_tags,)
        for tag in shared_tags:
            members = [t for t in tn.tag_map.get(tag, ()) if t in var_tids]
            if members:
                shared_groups[tag] = members
    grouped = {t for members in shared_groups.values() for t in members}

    params, mapping = {}, []
    for tag, members in shared_groups.items():
        params[tag] = tn.tensor_map[members[0]].data
        mapping.append((tag, members))
    for tid in var_tids:
        if tid not in grouped:
            params[tid] = tn.tensor_map[tid].data
            mapping.append((tid, [tid]))

    def build_fn(params):
        new = tn.copy()
        for key, tids in mapping:
            for tid in tids:
                new.tensor_map[tid].modify(data=params[key])
        return new

    return params, build_fn


# -- the first-order rules (optax 0.2.6) --------------------------------------


def _abs_sq(g):
    return (g.conj() * g).real if g.is_complex() else g * g


def _bias(t, decay, count):
    return t / (1 - decay**count)


class _Rule:
    """One optax rule as plain tensor updates: ``init(params)`` then, per
    step, ``step(params, grads) -> new params``. Every name and default
    is optax's."""

    def __init__(self, name, learning_rate, **opts):
        self.name = name
        self.lr = learning_rate
        defaults = _RULE_DEFAULTS[name]
        unknown = set(opts) - set(defaults)
        if unknown:
            raise TypeError(f"{name} got unexpected options {unknown}")
        self.o = {**defaults, **opts}
        self.count = 0
        self.state = None

    def init(self, params):
        o, name = self.o, self.name
        zeros = [torch.zeros_like(p) for p in params]
        if name in ("adam", "nadam", "adamw", "lamb", "adabelief"):
            self.state = (zeros, [torch.zeros_like(_abs_sq(p))
                                  for p in params])
        elif name == "sgd":
            self.state = zeros if o["momentum"] is not None else None
        elif name == "rmsprop":
            nu = [torch.full_like(_abs_sq(p), o["initial_scale"])
                  for p in params]
            mom = zeros if o["momentum"] is not None else None
            mu = ([torch.zeros_like(p) for p in params]
                  if o["centered"] else None)
            self.state = (nu, mom, mu)
        elif name == "adagrad":
            self.state = [torch.full_like(_abs_sq(p),
                                          o["initial_accumulator_value"])
                          for p in params]
        elif name == "lion":
            self.state = zeros
        elif name == "novograd":
            self.state = (zeros, [None] * len(params))
        elif name == "yogi":
            self.state = ([torch.full_like(p, 1e-6) for p in params],
                          [torch.full_like(_abs_sq(p), 1e-6)
                           for p in params])

    def step(self, params, grads):
        self.count += 1
        k = self.count
        fn = getattr(self, "_" + ("adam" if self.name in (
            "nadam", "adamw", "lamb") else self.name))
        updates = fn(params, grads, k)
        return [p - self.lr * u for p, u in zip(params, updates)]

    def _adam(self, params, grads, k):
        o = self.o
        b1, b2 = o["b1"], o["b2"]
        nesterov = o["nesterov"] or self.name == "nadam"
        mus, nus = self.state
        out = []
        for i, g in enumerate(grads):
            mus[i] = (1 - b1) * g + b1 * mus[i]
            nus[i] = (1 - b2) * _abs_sq(g) + b2 * nus[i]
            if nesterov:
                m_hat = (b1 * _bias(mus[i], b1, k + 1)
                         + (1 - b1) * _bias(g, b1, k))
            else:
                m_hat = _bias(mus[i], b1, k)
            v_hat = _bias(nus[i], b2, k)
            u = m_hat / (torch.sqrt(v_hat + o["eps_root"]) + o["eps"])
            if self.name in ("adamw", "lamb"):
                u = u + o["weight_decay"] * params[i]
            if self.name == "lamb":
                pn = torch.linalg.vector_norm(params[i])
                un = torch.linalg.vector_norm(u)
                ratio = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(pn), pn / un)
                u = u * ratio.to(u.dtype)
            out.append(u)
        return out

    def _sgd(self, params, grads, k):
        if self.state is None:
            return list(grads)
        out = []
        for i, g in enumerate(grads):
            self.state[i] = g + self.o["momentum"] * self.state[i]
            out.append(g + self.o["momentum"] * self.state[i]
                       if self.o["nesterov"] else self.state[i])
        return out

    def _rmsprop(self, params, grads, k):
        o = self.o
        nus, mom, mus = self.state
        d = o["decay"]
        out = []
        for i, g in enumerate(grads):
            nus[i] = (1 - d) * _abs_sq(g) + d * nus[i]
            nu_hat = _bias(nus[i], d, k) if o["bias_correction"] else nus[i]
            if mus is not None:
                mus[i] = (1 - d) * g + d * mus[i]
                mu_hat = _bias(mus[i], d, k) if o["bias_correction"] \
                    else mus[i]
                nu_hat = nu_hat - _abs_sq(mu_hat)
            if o["eps_in_sqrt"]:
                u = g * torch.rsqrt(nu_hat + o["eps"])
            else:
                u = g / (torch.sqrt(nu_hat) + o["eps"])
            if mom is not None:
                mom[i] = u + o["momentum"] * mom[i]
                u = (u + o["momentum"] * mom[i] if o["nesterov"]
                     else mom[i])
            out.append(u)
        return out

    def _adagrad(self, params, grads, k):
        out = []
        for i, g in enumerate(grads):
            t = _abs_sq(g) + self.state[i]
            self.state[i] = t
            scale = torch.where(t > 0, torch.rsqrt(t + self.o["eps"]),
                                torch.zeros_like(t))
            out.append(scale * g)
        return out

    def _adabelief(self, params, grads, k):
        o = self.o
        b1, b2 = o["b1"], o["b2"]
        mus, nus = self.state
        out = []
        for i, g in enumerate(grads):
            mus[i] = (1 - b1) * g + b1 * mus[i]
            nus[i] = ((1 - b2) * _abs_sq(g - mus[i]) + b2 * nus[i]
                      + o["eps_root"])
            if o["nesterov"]:
                m_hat = (b1 * _bias(mus[i], b1, k + 1)
                         + (1 - b1) * _bias(g, b1, k))
            else:
                m_hat = _bias(mus[i], b1, k)
            out.append(m_hat / (torch.sqrt(_bias(nus[i], b2, k))
                                + o["eps"]))
        return out

    def _lion(self, params, grads, k):
        o = self.o
        out = []
        for i, g in enumerate(grads):
            u = torch.sgn((1 - o["b1"]) * g + o["b1"] * self.state[i])
            self.state[i] = (1 - o["b2"]) * g + o["b2"] * self.state[i]
            out.append(u + o["weight_decay"] * params[i])
        return out

    def _novograd(self, params, grads, k):
        o = self.o
        mus, nus = self.state
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            n2 = torch.linalg.vector_norm(g) ** 2
            nus[i] = n2 if k == 1 else (1 - o["b2"]) * n2 + o["b2"] * nus[i]
            add = (g / (torch.sqrt(nus[i] + o["eps_root"]) + o["eps"])
                   + o["weight_decay"] * p)
            mus[i] = add if k == 1 else o["b1"] * mus[i] + add
            out.append(mus[i])
        return out

    def _yogi(self, params, grads, k):
        o = self.o
        b1, b2 = o["b1"], o["b2"]
        mus, nus = self.state
        out = []
        for i, g in enumerate(grads):
            mus[i] = (1 - b1) * g + b1 * mus[i]
            g2 = _abs_sq(g)
            nus[i] = nus[i] - (1 - b2) * torch.sign(nus[i] - g2) * g2
            out.append(_bias(mus[i], b1, k)
                       / (torch.sqrt(_bias(nus[i], b2, k)) + o["eps"]))
        return out


_ADAM = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False)
_RULE_DEFAULTS = {
    "adam": _ADAM,
    "nadam": _ADAM,
    "adamw": {**_ADAM, "weight_decay": 1e-4},
    "lamb": {**_ADAM, "eps": 1e-6, "weight_decay": 0.0},
    "sgd": dict(momentum=None, nesterov=False),
    "rmsprop": dict(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
                    centered=False, momentum=None, nesterov=False,
                    bias_correction=False),
    "adabelief": dict(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16,
                      nesterov=False),
    "adagrad": dict(initial_accumulator_value=0.1, eps=1e-7),
    "lion": dict(b1=0.9, b2=0.99, weight_decay=1e-3),
    "novograd": dict(b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0,
                     weight_decay=0.0),
    "yogi": dict(b1=0.9, b2=0.999, eps=1e-3),
}
_OPTAX_METHODS = set(_RULE_DEFAULTS)


class MultiLossHandler:
    """Evaluate a sequence of loss terms and sum them (reference
    ``MultiLossHandler`` optimize.py:707); with an ``executor`` the terms
    are submitted to it and run concurrently."""

    def __init__(self, loss_fns, executor=None, **loss_kwargs):
        self.loss_fns = tuple(loss_fns)
        self.executor = executor
        self.loss_kwargs = loss_kwargs

    def __call__(self, tn, **kwargs):
        opts = {**self.loss_kwargs, **kwargs}
        if self.executor is not None:
            grad = torch.is_grad_enabled()

            def run(fn):
                with torch.set_grad_enabled(grad):
                    return fn(tn, **opts)

            futures = [self.executor.submit(run, fn) for fn in self.loss_fns]
            vals = [f.result() for f in futures]
        else:
            vals = [fn(tn, **opts) for fn in self.loss_fns]
        tot = vals[0]
        for v in vals[1:]:
            tot = tot + v
        return tot


class TNOptimizer:
    """Optimize a network with respect to a loss (reference
    ``TNOptimizer`` optimize.py:1171)."""

    def __init__(self, tn, loss_fn, norm_fn=None, loss_constants=None,
                 loss_kwargs=None, tags=None, shared_tags=None,
                 constant_tags=None, autodiff_backend="torch", executor=None,
                 progbar=True, bounds=None, optimizer="L-BFGS-B",
                 learning_rate=0.01, **backend_opts):
        self.progbar = progbar
        self.optimizer = optimizer
        self.bounds = bounds
        self.learning_rate = learning_rate
        self.loss_constants = dict(loss_constants or {})
        self.loss_kwargs = dict(loss_kwargs or {})
        self.norm_fn = norm_fn if norm_fn is not None else (lambda x: x)
        self._tn = tn
        self._parse_opts = dict(tags=tags, shared_tags=shared_tags,
                                constant_tags=constant_tags)
        self.params, self.build_fn = parse_network_to_backend(
            tn, **self._parse_opts)
        if isinstance(loss_fn, (list, tuple)):
            loss_fn = MultiLossHandler(loss_fn, executor=executor)
        self._loss_fn = loss_fn
        self.loss = None
        self.losses = []
        self._n = 0
        self._pbar = None

    def _full_loss(self, params):
        tn_v = self.norm_fn(self.build_fn(params))
        val = self._loss_fn(tn_v, **self.loss_constants, **self.loss_kwargs)
        val = val if isinstance(val, torch.Tensor) else torch.as_tensor(val)
        return val.real if val.is_complex() else val

    def _value_and_grad(self, params):
        """The loss and its gradient (a dict like ``params``), both on the
        parameters' device."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            val = self._full_loss(leaves)
            grads = torch.autograd.grad(val, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        return val.detach(), grads

    @property
    def nevals(self):
        return self._n

    def _record(self, v):
        self._n += 1
        self.losses.append(v)
        self.loss = v
        if self._pbar is not None:
            self._pbar.update()
            self._pbar.set_description(f"{v:+.12f}")

    def vectorized_value_and_grad(self, x):
        val, grads = self._value_and_grad(self._vectorizer.unpack(x))
        v = float(val)
        self._record(v)
        return v, self._vectorizer.pack(grads)

    def optimize(self, n, tol=None, **options):
        """Run ``n`` iterations of ``self.optimizer``."""
        if str(self.optimizer).lower() in _OPTAX_METHODS:
            return self._optimize_rule(n, tol=tol, **options)
        return self._optimize_scipy(n, tol=tol, **options)

    def _optimize_scipy(self, n, tol=None, method=None, **options):
        from scipy.optimize import minimize

        method = method or self.optimizer
        self._vectorizer = Vectorizer(self.params)
        x0 = self._vectorizer.pack(self.params)
        bounds = None
        if self.bounds is not None:
            bounds = [tuple(self.bounds)] * x0.size
        hessp = self.vectorized_hessp if method in (
            "Newton-CG", "trust-ncg", "trust-krylov", "trust-constr") \
            else None
        self._pbar = Progbar(total=n) if self.progbar else None
        try:
            res = minimize(self.vectorized_value_and_grad, x0, jac=True,
                           hessp=hessp, method=method, bounds=bounds,
                           options={"maxiter": n, **options}, tol=tol)
            self.params = self._vectorizer.unpack(res.x)
        finally:
            if self._pbar is not None:
                self._pbar.close()
            self._pbar = None
        return self.get_tn_opt()

    optimize_scipy = _optimize_scipy

    def _optimize_rule(self, n, tol=None, **options):
        rule = _Rule(str(self.optimizer).lower(), self.learning_rate,
                     **options)
        keys = list(self.params)
        params = [self.params[k].detach() for k in keys]
        rule.init(params)
        self._pbar = Progbar(total=n) if self.progbar else None
        last = None
        try:
            for _ in range(n):
                val, grads = self._value_and_grad(dict(zip(keys, params)))
                with torch.no_grad():
                    params = rule.step(params, [grads[k] for k in keys])
                v = float(val)
                self._record(v)
                if tol is not None and last is not None and \
                        abs(last - v) < tol:
                    break
                last = v
        finally:
            if self._pbar is not None:
                self._pbar.close()
            self._pbar = None
        self.params = dict(zip(keys, params))
        return self.get_tn_opt()

    def optimize_basinhopping(self, n, nhop, temperature=1.0, **options):
        """Basin-hopping global optimization (reference
        optimize.py:1560)."""
        from scipy.optimize import basinhopping

        self._vectorizer = Vectorizer(self.params)
        x0 = self._vectorizer.pack(self.params)
        self._pbar = Progbar(total=n * nhop) if self.progbar else None
        try:
            res = basinhopping(
                self.vectorized_value_and_grad, x0, niter=nhop,
                T=temperature, minimizer_kwargs={
                    "jac": True, "method": "L-BFGS-B",
                    "options": {"maxiter": n}}, **options)
            self.params = self._vectorizer.unpack(res.x)
        finally:
            if self._pbar is not None:
                self._pbar.close()
            self._pbar = None
        return self.get_tn_opt()

    @property
    def d(self):
        """The number of real degrees of freedom."""
        return Vectorizer(self.params).d

    def vectorized_value(self, x):
        """The loss at the packed vector ``x``."""
        with torch.no_grad():
            v = float(self._full_loss(Vectorizer(self.params).unpack(x)))
        self._n += 1
        self.loss = v
        self.losses.append(v)
        return v

    def vectorized_hessp(self, x, p):
        """The Hessian of the loss at the packed vector ``x`` times the
        packed direction ``p`` (reference ``vectorized_hessp``), by a
        second backward pass."""
        vec = Vectorizer(self.params)
        params = vec.unpack(x)
        tangents = vec.unpack(p)
        keys = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in keys]
        with torch.enable_grad():
            val = self._full_loss(dict(zip(keys, leaves)))
            grads = torch.autograd.grad(val, leaves, create_graph=True,
                                        allow_unused=True)
            dot = sum(torch.sum((g.conj() * tangents[k]).real)
                      for g, k in zip(grads, keys) if g is not None)
            hvp = torch.autograd.grad(dot, leaves, allow_unused=True)
        return vec.pack({k: torch.zeros_like(v) if h is None else h
                         for k, v, h in zip(keys, leaves, hvp)})

    def optimize_ipopt(self, n, **options):
        """Optimize with ``ipopt`` (needs the ``cyipopt`` package, which
        is not bundled)."""
        import cyipopt  # noqa: F401

        raise NotImplementedError("cyipopt backend not bundled; use "
                                  "optimize() instead")

    def optimize_nlopt(self, n, **options):
        """Optimize with ``nlopt`` (needs the ``nlopt`` package, which is
        not bundled)."""
        import nlopt  # noqa: F401

        raise NotImplementedError("nlopt backend not bundled; use "
                                  "optimize() instead")

    def optimize_nevergrad(self, n, **options):
        """Optimize with ``nevergrad`` (needs the ``nevergrad`` package,
        which is not bundled)."""
        import nevergrad  # noqa: F401

        raise NotImplementedError("nevergrad backend not bundled; use "
                                  "optimize() instead")

    def plot(self, zoom=None, hlines=(), **kwargs):
        """Plot the loss history (reference ``TNOptimizer.plot``)."""
        from ..utils_plot import plot_multi_series_zoom

        fig, ax = plot_multi_series_zoom(
            {"loss": self.losses}, zoom=zoom, **kwargs
        )
        ax.set_xlabel("iteration")
        ax.set_ylabel("loss")
        for h in hlines:
            ax.axhline(h, color="grey", ls="--")
        return fig, ax

    def get_tn_opt(self):
        """The current optimized network, norm_fn applied, detached."""
        out = self.norm_fn(self.build_fn(self.params)).copy()
        out.apply_to_arrays(lambda x: x.detach())
        return out

    def reset(self, tn=None):
        """Start again from ``tn`` (or the network given at construction),
        with the same ``tags``, ``shared_tags`` and ``constant_tags``."""
        if tn is not None:
            self._tn = tn
        self.params, self.build_fn = parse_network_to_backend(
            self._tn, **self._parse_opts)
        self.losses = []
        self._n = 0
