"""What importing quimb_torch does, and does not do, in a fresh
interpreter (this test process has JAX loaded by the test configuration,
so each check runs in a subprocess)."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(code, *args):
    return subprocess.run([sys.executable, *args, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_import_never_imports_jax():
    res = _run(
        "import sys, quimb_torch, quimb_torch.tensor, quimb_torch.convert\n"
        "import quimb_torch.core, quimb_torch.linalg.base_linalg\n"
        "import quimb_torch.evo, quimb_torch.gen.states\n"
        "import quimb_torch.tensor.core, quimb_torch.ops.contraction\n"
        "import quimb_torch.ops.paths, quimb_torch.ops.native\n"
        "import quimb_torch.tensor.networking, quimb_torch.utils\n"
        "import quimb_torch.tensor.array_ops, quimb_torch.gen.rand\n"
        "import quimb_torch.tensor.simplify, quimb_torch.tensor.gating\n"
        "import quimb_torch.tensor.circuit.core\n"
        "import quimb_torch.tensor.circuit.gates\n"
        "import quimb_torch.tensor.circuit.qasm\n"
        "import quimb_torch.tensor.tn1d.core\n"
        "import quimb_torch.tensor.tn2d.core, quimb_torch.tensor.tn2d.tebd\n"
        "import quimb_torch.tensor.tn2d.su_fused\n"
        "import quimb_torch.tensor.tn2d.builders\n"
        "import quimb_torch.tensor.tn2d.compress\n"
        "import quimb_torch.tensor.circuit.peps\n"
        "import quimb_torch.tensor.circuit.simple_update\n"
        "import quimb_torch.calc, quimb_torch.tensor.tn1d.dmrg_cyclic\n"
        "import quimb_torch.tensor.tn1d.dmrg_jacobi\n"
        "import quimb_torch.tensor.geometry, quimb_torch.tensor.tnag\n"
        "import quimb_torch.tensor.tnag.core, quimb_torch.tensor.tnag.builders\n"
        "import quimb_torch.tensor.tnag.compress\n"
        "import quimb_torch.tensor.tnag.tebd\n"
        "import quimb_torch.tensor.circuit.pepo\n"
        "import quimb_torch.tensor.tn3d, quimb_torch.tensor.tn3d.core\n"
        "import quimb_torch.tensor.tn3d.tebd\n"
        "import quimb_torch.tensor.tensor_builder\n"
        "import quimb_torch.tensor.circuit_gen\n"
        "import quimb_torch.tensor.belief_propagation\n"
        "from quimb_torch.tensor.belief_propagation import (\n"
        "    bp_common, d1bp, d2bp, hv1bp, mps1bp, extras, gbp)\n"
        "import quimb_torch.tensor.interface, quimb_torch.tensor.optimize\n"
        "import quimb_torch.tensor.fitting, quimb_torch.tensor.linop\n"
        "import quimb_torch.tensor.tensor_approx_spectral\n"
        "import quimb_torch.tensor.tn1d.mera, quimb_torch.tensor.tn1d.compress\n"
        "import quimb_torch.experimental\n"
        "import quimb_torch.experimental.cluster_update\n"
        "import quimb_torch.linalg.approx_spectral\n"
        "import quimb_torch.linalg.rand_linalg\n"
        "import quimb_torch.linalg.autoblock, quimb_torch.gates\n"
        "import quimb_torch.operator, quimb_torch.operator.configdevice\n"
        "import quimb_torch.operator.pepobuilder\n"
        "import quimb_torch.parallel, quimb_torch.parallel.mesh\n"
        "import quimb_torch.parallel.pools, quimb_torch.parallel.dryrun\n"
        "import quimb_torch.tensor.tn1d.dmrg_mesh\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'optax' not in sys.modules, 'optax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_optimisation_and_fitting_never_import_jax_or_optax_when_used():
    """Every first-order rule, an L-BFGS-B step, an ALS fit, a MERA, a
    linear operator's SLQ estimate and a randomized SVD load neither jax,
    optax nor quimb_tpu."""
    res = _run(
        "import sys, torch\n"
        "import quimb_torch as qt\n"
        "from quimb_torch.tensor import optimize\n"
        "psi = qt.MPS_rand_state(4, 2, device='cpu')\n"
        "loss = lambda p: (p.H @ p).real\n"
        "for name in sorted(optimize._OPTAX_METHODS) + ['L-BFGS-B']:\n"
        "    qt.TNOptimizer(psi, loss, optimizer=name, progbar=False)"
        ".optimize(1)\n"
        "psi.fit(qt.MPS_rand_state(4, 2, device='cpu'), steps=1)\n"
        "qt.MERA.rand(4, seed=1, device='cpu').isometrize()\n"
        "A = psi.partial_trace_linop((1, 2))\n"
        "qt.tensor_network_approx_spectral_function(A, qt.xlogx, R=8)\n"
        "qt.rsvd(torch.rand(6, 5, dtype=torch.float64), 2)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'optax' not in sys.modules, 'optax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_object_layer_never_imports_jax_when_used():
    """Building and contracting a network, its path search (native
    library included) and a split load neither jax nor quimb_tpu."""
    res = _run(
        "import sys, torch\n"
        "from quimb_torch.tensor import Tensor, TensorNetwork\n"
        "from quimb_torch.ops import native\n"
        "ts = [Tensor(torch.rand(2, 3, 2), inds=(f'k{i}', f'p{i}', "
        "f'k{i + 1}'), tags=f'I{i}') for i in range(12)]\n"
        "tn = TensorNetwork(ts)\n"
        "tn.contract(..., optimize='auto')\n"
        "tn.canonize_between('I0', 'I1')\n"
        "tn.compress_between('I1', 'I2', max_bond=1, cutoff=0.0)\n"
        "ts[3].split(('k3',), max_bond=1, cutoff=0.0)\n"
        "native.native_available()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_circuit_never_imports_jax_when_used():
    """Building a circuit from QASM, simplifying, gating, an amplitude, a
    marginal and two samples load neither jax nor quimb_tpu."""
    res = _run(
        "import sys\n"
        "from quimb_torch.tensor import Circuit\n"
        "q = ('OPENQASM 2.0;\\nqreg q[4];\\nh q[0];\\ncx q[0],q[1];\\n'\n"
        "     'u3(0.1,0.2,0.3) q[2];\\ncz q[1],q[2];\\ncx q[2],q[3];\\n')\n"
        "c = Circuit.from_openqasm2_str(q, device='cpu')\n"
        "c.amplitude('0000')\n"
        "c.compute_marginal((0, 1), fix={3: 0})\n"
        "list(c.sample(2, seed=1, group_size=2))\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_peps_layer_never_imports_jax_when_used():
    """A PEPS, a fused SimpleUpdate step, a boundary energy and a
    CircuitPEPS amplitude load neither jax nor quimb_tpu."""
    res = _run(
        "import sys\n"
        "import quimb_torch.tensor as ttn\n"
        "psi = ttn.PEPS_rand(2, 3, 2, seed=1, device='cpu')\n"
        "ham = ttn.ham_2d_heis(2, 3)\n"
        "su = ttn.SimpleUpdate(psi, ham, D=2, compute_energy_final=False)\n"
        "su.evolve(1, tau=0.1)\n"
        "su.get_state().compute_local_expectation(ham.terms, max_bond=8)\n"
        "c = ttn.CircuitPEPS(2, device='cpu')\n"
        "c.apply_gate('H', 0)\n"
        "c.apply_gate('CZ', 0, 1)\n"
        "c.amplitude('0000')\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_cuda_kernels_build_nothing_on_cpu():
    """Importing the kernel module and using it on CPU tensors needs no
    nvcc and builds nothing."""
    res = _run(
        "import sys, torch\n"
        "from quimb_torch.ops import _build, cuda_kernels as ck\n"
        "def no_build():\n"
        "    raise AssertionError('kernel build attempted')\n"
        "_build.build = no_build\n"
        "a = torch.ones((2, 3, 3)); th = torch.ones((3, 4))\n"
        "b = torch.ones((2, 4, 5))\n"
        "assert ck.sandwich_matvec(a, th, b).shape == (3, 5)\n"
        "assert _build.load_library.cache_info().currsize == 0\n"
        "assert 'torch.utils.cpp_extension' not in sys.modules\n"
    )
    assert res.returncode == 0, res.stderr


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    res = _run("import runpy; runpy.run_path('chip_smoke.py', "
               "run_name='__main__')")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_rings_and_2d_layer_never_import_jax_when_used():
    """A ring DMRG sweep, a ring TEBD step, a FullUpdate gate and the
    HOTRG, CTMRG and full-bond contractions load neither jax nor
    quimb_tpu."""
    res = _run(
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import quimb_torch as qt\n"
        "from quimb_torch.calc import heisenberg_energy\n"
        "d = qt.DMRG2(qt.MPO_ham_heis(8, cyclic=True, device='cpu'), "
        "bond_dims=4, cyclic_mode='segmented')\n"
        "d.sweep('R', max_bond=4, cutoff=1e-10)\n"
        "heisenberg_energy(8)\n"
        "t = qt.TEBD(qt.MPS_neel_state(6, cyclic=True, device='cpu'), "
        "qt.ham_1d_heis(6, cyclic=True), split_opts={'max_bond': 4})\n"
        "t.update_to(0.05, dt=0.05)\n"
        "p = qt.PEPS_rand(2, 2, 2, seed=1, device='cpu', "
        "dtype=torch.float64)\n"
        "fu = qt.FullUpdate(p, qt.ham_2d_heis(2, 2), D=2, "
        "compute_energy_final=False)\n"
        "fu.evolve(1, tau=0.1)\n"
        "n = p.make_norm()\n"
        "n.contract_hotrg(max_bond=8), n.contract_ctmrg(max_bond=8)\n"
        "n.contract_boundary(max_bond=4, mode='full-bond')\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_jacobi_and_arbitrary_geometry_never_import_jax_when_used():
    """A JacobiDMRG sweep, a SimpleUpdateGen step with its cluster energy
    under a thread pool, a 2D compression of a direct sum and a
    CircuitPEPOSimpleUpdate expectation load neither jax nor quimb_tpu."""
    res = _run(
        "import sys, torch\n"
        "from concurrent.futures import ThreadPoolExecutor\n"
        "torch.set_num_threads(1)\n"
        "import quimb_torch as qt\n"
        "from quimb_torch.tensor.tn1d.dmrg_jacobi import JacobiDMRG\n"
        "H = qt.MPO_ham_heis(8, device='cpu')\n"
        "d = qt.DMRG2(H, bond_dims=4)\n"
        "d.sweep('R', max_bond=4, cutoff=1e-10)\n"
        "JacobiDMRG(d.state, H, max_bond=4).sweep()\n"
        "e = qt.edges_2d_kagome(1, 2)\n"
        "psi = qt.TN_from_edges_rand(e, 2, phys_dim=2, seed=1, "
        "dtype='float64', device='cpu')\n"
        "su = qt.SimpleUpdateGen(psi, qt.ham_gen_heis(e), D=2, "
        "compute_energy_final=False)\n"
        "su.evolve(1, tau=0.1)\n"
        "with ThreadPoolExecutor(2) as ex:\n"
        "    su.get_state().compute_local_expectation(\n"
        "        qt.ham_gen_heis(e).terms, executor=ex)\n"
        "p = qt.PEPS_rand(2, 2, 2, seed=1, device='cpu', "
        "dtype=torch.float64)\n"
        "qt.tensor_network_2d_compress(p.add_PEPS(p), max_bond=2)\n"
        "c = qt.CircuitPEPOSimpleUpdate(N=4, max_bond=4, device='cpu')\n"
        "c.apply_gates([('H', 0), ('CNOT', 0, 1), ('CZ', 1, 2)])\n"
        "c.local_expectation([[1.0, 0.0], [0.0, -1.0]], 1)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_3d_layer_and_bp_never_import_jax_when_used():
    """A 3D boundary and CTMRG contraction, a SimpleUpdate3D step, the
    network builders, a circuit ansatz, the BP engines (D1BP, D2BP, HV1BP)
    and the BP gauge load neither jax nor quimb_tpu."""
    res = _run(
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import quimb_torch as qt\n"
        "from quimb_torch.tensor import belief_propagation as bp\n"
        "z = qt.TN3D_classical_ising_partition_function(2, 2, 3, beta=0.2, "
        "device='cpu')\n"
        "z.contract_boundary(max_bond=4), z.contract_ctmrg(max_bond=4)\n"
        "p = qt.PEPS3D.rand(2, 2, 1, 2, seed=1, device='cpu')\n"
        "qt.SimpleUpdate3D(p, qt.ham_3d_heis(2, 2, 1), D=2).evolve(1, 0.1)\n"
        "h = qt.HTN3D_classical_ising_partition_function(2, 2, 2, beta=0.2, "
        "h=0.1, device='cpu')\n"
        "bp.contract_hv1bp(h), bp.contract_hd1bp(h)\n"
        "k = qt.HTN_random_ksat(3, 8, alpha=2.0, seed=1, device='cpu')\n"
        "bp.contract_hv1bp(k)\n"
        "s = qt.TN_from_edges_rand(qt.edges_2d_square(2, 2), 2, phys_dim=2, "
        "seed=1, dtype='float64', device='cpu')\n"
        "bp.contract_d2bp(s), bp.compress_d2bp(s, max_bond=1)\n"
        "s.gauge_all_belief_propagation()\n"
        "qt.circ_ansatz_1D_brickwork(4, 2, seed=1, device='cpu').amplitude("
        "'0000')\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_matrix_half_never_imports_jax_when_used():
    """A sector operator solved by Lanczos, calc's entropy, an RK45
    evolution and a dense circuit load neither jax nor quimb_tpu."""
    res = _run(
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import quimb_torch as qt\n"
        "from quimb_torch import calc, operator\n"
        "hs = operator.HilbertSpace(8, symmetry='U1', sector=4)\n"
        "b = operator.heisenberg_from_edges([(i, (i + 1) % 8) for i in "
        "range(8)], hilbert_space=hs)\n"
        "op = b.build_coupled_ham(device='cpu')\n"
        "psi = qt.groundstate(op)\n"
        "H = qt.ham_heis(6, sparse=True)\n"
        "g = qt.groundstate(H, device='cpu')\n"
        "calc.entropy_subsys(g, (2,) * 6, (0, 1, 2))\n"
        "e = qt.Evolution(qt.computational_state('010101', device='cpu'), "
        "H, method='integrate')\n"
        "e.update_to(0.1)\n"
        "c = qt.CircuitDense(4, device='cpu')\n"
        "c.apply_gate('H', 0).apply_gate('CNOT', 0, 3)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'quimb_tpu' not in sys.modules, 'quimb_tpu imported'\n"
    )
    assert res.returncode == 0, res.stderr


def test_slice16_modules_import_with_jax_blocked_and_no_matplotlib():
    """With jax made unimportable, every module of the default-dtype
    stack, experimental/ and the drawing code imports and runs a VMC step,
    a CP decomposition, CTMRG and the marginals; neither ``import
    quimb_torch`` nor these modules load matplotlib."""
    res = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quimb_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import quimb_torch as qt\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib at import'\n"
        "import quimb_torch.config, quimb_torch.utils, quimb_torch.utils_plot\n"
        "import quimb_torch.schematic, quimb_torch.tensor.drawing\n"
        "from quimb_torch.experimental import (autojittn, cp_decomp,\n"
        "    merabuilder, misc, tn_marginals, tnvmc)\n"
        "import quimb_torch.experimental as ex\n"
        "from quimb_torch.operator import heisenberg_from_edges\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "with qt.config.default_dtype('float32'):\n"
        "    assert qt.tensor.MPS_rand_state(3, 2, device='cpu').dtype == "
        "torch.float32\n"
        "rng = np.random.default_rng(0)\n"
        "arrs = [[torch.as_tensor(rng.standard_normal([2] * sum((i < 1, "
        "j < 1, i > 0, j > 0)) + [2])) for j in range(2)] for i in range(2)]\n"
        "psi = qt.PEPS(arrs, shape='urdlp')\n"
        "H = heisenberg_from_edges([(0, 1), (2, 3), (0, 2), (1, 3)])\n"
        "vmc = ex.TNVMC(psi, H, nchains=8)\n"
        "vmc.run(1, progbar=False, burn_in=2)\n"
        "t = qt.Tensor(torch.ones(2, 2, 2, dtype=torch.float64), "
        "inds=('a', 'b', 'c'))\n"
        "ex.cp_decompose(t, 1, steps=3)\n"
        "T, A, C = ex.classical_ising_T_A_C(0.4, device='cpu')\n"
        "ex.ctmrg_partition_function(T, A, C, 6, 4)\n"
        "tn = qt.TN3D_classical_ising_partition_function(2, 2, 2, beta=0.2, "
        "device='cpu')\n"
        "ex.compute_all_marginals_via_autodiff(tn, sorted(tn.inner_inds())[:2])\n"
        "ex.TTN_randtree_rand(range(4), 2, seed=1, device='cpu')\n"
        "assert qt.LRU is quimb_torch.utils.LRU and callable(qt.plot)\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib when used'\n"
    )
    assert res.returncode == 0, res.stderr
