"""quimb_torch's ``Evolution`` with ``method="integrate"`` and ``"solve"``,
density operators and the Lindblad equation, against quimb_tpu's, on the
CPU: the right-hand sides, one Dormand-Prince step, the adaptive RK45 of
kets and density operators (the same host step control, so the same
steps: states agree to 1e-12), the time-dependent RK4, ``int_stop``, the
eigenbasis ``solve``, and the ``TypeError`` of a density operator under
``expm`` (kets only, in both packages). complex128 on both sides;
Hamiltonians of 5-6 spins (``ham_heis``), dephasing ``Z_i`` on every
site."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.core as jcore
import quimb_tpu.evo as jevo
import quimb_tpu.gen.operators as jops
import quimb_tpu.gen.states as jstates
from quimb_torch import core as tcore
from quimb_torch import evo as tevo
from quimb_torch.gen import operators as tops
from quimb_torch.gen import states as tstates

CPU = "cpu"


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(got, want, tol=1e-12):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=tol)


def _setup(n):
    Hd = np.asarray(jops.ham_heis(n))
    ls = [np.asarray(jcore.ikron(np.asarray(jops.pauli("Z")), (2,) * n, i))
          for i in range(n)]
    k0 = "01" * (n // 2) + "0" * (n % 2)
    return Hd, ls, k0


def test_right_hand_sides_and_one_step():
    Hd, ls, k0 = _setup(4)
    rng = np.random.default_rng(0)
    y = rng.standard_normal((16, 1)) + 1j * rng.standard_normal((16, 1))
    R = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    _same(tevo.schrodinger_eq_ket(T(Hd))(T(y)),
          jevo.schrodinger_eq_ket(Hd)(y))
    _same(tevo.schrodinger_eq_dop(T(Hd), device=CPU)(T(R)),
          jevo.schrodinger_eq_dop(Hd)(R))
    rhs_t = tevo.lindblad_eq(T(Hd), [T(L) for L in ls], 0.3, device=CPU)
    rhs_j = jevo.lindblad_eq(Hd, ls, 0.3)
    _same(rhs_t(T(R)), rhs_j(R))
    for dt in (0.05, 0.3):
        yt, et = tevo.rk45_step(rhs_t, T(R), dt)
        yj, ej = jevo._rk45_step_factory(rhs_j)(jnp.asarray(R),
                                                jnp.asarray(dt, complex))
        _same(yt, yj)
        assert float(et) == pytest.approx(float(jnp.real(ej)), rel=1e-9)


def test_integrate_kets_and_density_operators():
    """A ket under the sparse Hamiltonian, and the same ket's density
    operator under the dense one, at three times; the port counts its
    steps and host reads."""
    n = 6
    Hs = jops.ham_heis(n, sparse=True)
    Hd, _, k0 = _setup(n)
    ts = (0.1, 0.35, 0.6)
    p0j = jstates.computational_state(k0)
    p0t = tstates.computational_state(k0, device=CPU)
    jk = jevo.Evolution(p0j, Hs, method="integrate")
    tk = tevo.Evolution(p0t, tops.ham_heis(n, sparse=True),
                        method="integrate", compute=lambda t, p: t)
    for a, b in zip(tk.at_times(ts), jk.at_times(ts)):
        _same(a, b, tol=1e-12)
    assert tk.results == list(ts)
    assert tk.steps > 0 and tk.host_reads == tk.steps + tk.rejected + 3
    jd = jevo.Evolution(jcore.dop(p0j), Hd, method="integrate")
    td = tevo.Evolution(tcore.dop(p0t), torch.as_tensor(Hd),
                        method="integrate")
    for a, b in zip(td.at_times(ts[:2]), jd.at_times(ts[:2])):
        _same(a, b, tol=1e-12)
    # the density operator is the solved ket's, to the integrator's
    # tolerance (rtol 1e-8 a step)
    ref = tevo.Evolution(p0t, torch.as_tensor(Hd), method="solve")
    ref.update_to(ts[1])
    _same(td.pt, tcore.dop(ref.pt), tol=1e-7)


def test_lindblad_tuple_and_solve():
    """Dephasing on every site of a 5-spin chain: the Lindblad tuple
    ``(H, ls, gamma)`` against quimb_tpu's, and the dissipationless
    ``solve`` of a ket and a density operator."""
    n = 5
    Hd, ls, k0 = _setup(n)
    p0j = jcore.dop(jstates.computational_state(k0))
    p0t = tcore.dop(tstates.computational_state(k0, device=CPU))
    jl = jevo.Evolution(p0j, (Hd, ls, 0.1), method="integrate")
    tl = tevo.Evolution(p0t, (torch.as_tensor(Hd), ls, 0.1),
                        method="integrate")
    jl.update_to(0.5)
    tl.update_to(0.5)
    _same(tl.pt, jl.pt, tol=1e-12)
    assert complex(torch.trace(tl.pt)) == pytest.approx(1.0, abs=1e-10)
    # a ket start is taken to its density operator
    tk = tevo.Evolution(tstates.computational_state(k0, device=CPU),
                        (torch.as_tensor(Hd), ls, 0.1), method="integrate")
    tk.update_to(0.5)
    _same(tk.pt, tl.pt, tol=0)
    for p0, q0 in ((p0t, p0j), (tstates.computational_state(k0, device=CPU),
                                jstates.computational_state(k0))):
        ts_ = tevo.Evolution(p0, torch.as_tensor(Hd), method="solve",
                             t0=0.1)
        js_ = jevo.Evolution(q0, Hd, method="solve", t0=0.1)
        for t in (0.4, 1.3):
            ts_.update_to(t)
            js_.update_to(t)
            _same(ts_.pt, js_.pt, tol=1e-12)
    with pytest.raises(TypeError):
        tevo.Evolution(p0t, (torch.as_tensor(Hd), ls, 0.1), method="solve")


def test_expm_of_a_density_operator_and_int_stop():
    n = 5
    Hd, _, k0 = _setup(n)
    H = torch.as_tensor(Hd)
    # 'expm' takes kets only: quimb_tpu's raises a TypeError at the first
    # update, the port's when it is built
    with pytest.raises(TypeError):
        jevo.Evolution(jcore.dop(jstates.computational_state(k0)), Hd,
                       method="expm").update_to(0.2)
    with pytest.raises(TypeError):
        tevo.Evolution(tcore.dop(tstates.computational_state(k0, device=CPU)),
                       H, method="expm")
    stop = tevo.Evolution(tstates.computational_state(k0, device=CPU), H,
                          method="integrate",
                          int_stop=lambda t, p: t > 0.25)
    stop.update_to(1.0)
    assert 0.25 < stop.t < 1.0
    ref = tevo.Evolution(tstates.computational_state(k0, device=CPU), H,
                         method="solve")
    ref.update_to(stop.t)
    _same(stop.pt, ref.pt, tol=1e-7)


def test_time_dependent_rk4():
    """A driven 3-spin chain, H(t) = H0 + cos(t) X_0, by quimb_tpu's fixed
    RK4 (100 steps)."""
    n = 3
    Hd, _, _ = _setup(n)
    X0 = np.asarray(jcore.ikron(np.asarray(jops.pauli("X")), (2,) * n, 0))
    p0 = "010"

    def ham_j(t):
        return jnp.asarray(Hd + np.cos(t) * X0)

    def ham_t(t):
        return torch.as_tensor(Hd + np.cos(t) * X0)

    je = jevo.Evolution(jstates.computational_state(p0), ham_j,
                        method="integrate")
    te = tevo.Evolution(tstates.computational_state(p0, device=CPU), ham_t,
                        method="integrate")
    je.update_to(0.7)
    te.update_to(0.7)
    _same(te.pt, je.pt, tol=1e-12)
    with pytest.raises(TypeError):
        tevo.Evolution(tstates.computational_state(p0, device=CPU), ham_t,
                       method="expm")
