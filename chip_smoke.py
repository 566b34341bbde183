"""Smoke run of quimb_torch's main path on one CUDA GPU.

Run from the root of the repository, on a machine with an NVIDIA Hopper
GPU and the CUDA toolkit::

    python3 chip_smoke.py

It drives the 1D ground-state engine of the spin-1/2 Heisenberg chain at
L=128, chi=256 through the package's entry points (``MPO_ham_heis`` and
``MPS_rand_state`` build an MPO and an MPS object; ``DMRG2``, ``DMRG1``
and ``ParallelDMRG`` take them, and ``.state`` is an MPS): DMRG2 on a
float32 state, with every effective-Hamiltonian matvec in the
hand-written 3xTF32 sandwich kernel and every bond split by the card's
default split (``svd:sub``, run as ``svd:sub0`` at cutoff 0), then
ParallelDMRG from that state; DMRG2 on a float64 state, with every matvec
in the hand-written FP64 tensor-core (DMMA) kernel, then DMRG1 from that
state. Then the MPS / MPO object layer on that state, the TEBD quench,
the exact 20-qubit core, the 53-qubit circuit as a lazy network and as
an MPS, the 16x16 PEPS, the rings, JacobiDMRG, the arbitrary-geometry
layer, the 3D layer, belief propagation, optimisation and the spectral
estimates, and the matrix half: sector exact diagonalisation, calc,
Evolution's RK45 and CircuitDense at 28 qubits. Its phases, each fatal on
failure:

1. the device: a CUDA GPU is required; its name and power limit are
   printed;
2. the build of ``quimb_torch/csrc`` with nvcc, timed; ptxas must report
   no spills, and the float64 kernel's SASS must hold DMMA instructions;
3. the kernels against their plain einsum (in float64) on the card, in
   float32 (3xTF32) and float64 (DMMA) at the paths' shapes; two
   applications of one prepared operand set, and a one-shot call, must
   agree bitwise; for each dtype, CUDA-event times of the matvec and the
   plain einsum at the north-star shape, in the order plain, kernel,
   kernel, plain, the prepare step's time and each launch's device time
   (``torch.profiler``);
4. the float32 DMRG2 path: right sweeps at max_bond 64, 128, 256, 256,
   256, then one left sweep; each sweep must launch the float32 kernel
   at least ncv * restarts * (L - 1) times and the float64 one never;
   the final state's energy, evaluated in float64 on the host, must lie
   within a relative 2e-5 of E_REF;
5. where one bulk bond's time goes, phase by phase, the path's split and
   ``gesvd``'s masked SVD both timed;
6. the split methods at that bond's updated theta, with the center of
   the state at the bond: ``svd`` (cutoff 0 and 1e-10), ``svd:eig``,
   ``svd:sub`` (cutoff 1e-10) and ``svd:sub0``, each timed, with its
   residual and the orthogonality of its isometric factor; the factors
   must be finite and the isometric one orthogonal to 1e-4 (float32) or
   1e-10 (float64); in float64 the ``svd:eig`` residual must lie within
   1 % of ``gesvd``'s, and a subspace method's within twice ``gesvd``'s
   at the same cutoff (or within ``gesvd``'s plus 1.5e-8, the float64
   floor of a gram-matrix method);
7. the ParallelDMRG path from the float32 DMRG2 state, with bench.py's
   settings (S=2 segments, ncv=8, 3 inner passes): two outer sweeps,
   each launching the float32 kernel at least (2 * 3 + 1) * S' * 63 * 8
   times (S' its count of segments: 2, then 1 at the offset) and the
   float64 one never; the final state's host energy within a relative
   2e-5 of E_REF;
8. the float64 DMRG2 path: the schedule of phase 4 on a float64 state;
   each sweep must launch the float64 kernel at least ncv * restarts *
   (L - 1) times and the float32 one never; the host energy must lie
   within a relative 1e-6 of E_REF; then phases 5 and 6 on one of its
   bulk bonds;
9. the DMRG1 path from the float64 DMRG2 state: one right and one left
   sweep at max_bond 256, each launching the float64 kernel once per
   Lanczos vector at every site (8, and 4 at each chain end, whose
   one-site space has dimension 4) and the float32 one never; the host
   energy within a relative 1e-6 of E_REF, and no more than 1e-9
   relative above the DMRG2 state's;
10. the TEBD real-time quench of benchref/measure_tpu_tebd.py, once in
   complex128 (quimb's dtype) and once in complex64 (the TPU bench's):
   the Heisenberg chain at L=64 from the Néel state, max_bond 64, cutoff
   1e-10, 20 fourth-order steps of dt 0.05, through entry points called
   with no device (so on the GPU). Each step is timed with a synchronised
   host clock after a warm-up of 2 dt on a copy. Every stack must be on
   the GPU, finite and in the dtype asked for; the 20 half-chain
   entropies within 2e-4 of the reference curve in benchref/REFBASE.json
   (both dtypes); ``err`` within 1e-9 relative of the reference's; the
   final state's norm, on the host in float64, within 1e-8 or 1e-4 of 1;
   the quench's own SVD route (the checked complex128 ``gesvdj``, a
   complex64 batch taken to complex128) orthogonal on one parity sweep's
   batch; and no sandwich kernel launched. Printed, not gated: the
   distance to quimb_tpu's own complex128 CPU curve, the discarded
   weight, the device's busy share over one step (``torch.profiler``),
   the SVD drivers of cuSOLVER on that (32, 128, 128) batch, time and
   orthogonality of each, and the batches ``gesvdj`` failed on and
   ``gesvd`` redid;
11. the exact 20-qubit core of benchref/measure_tpu_exact20.py (20 1.0 4)
   through entry points called with no device: ``ham_heis(20,
   sparse=True)``, ``groundenergy`` twice (cold, warm) and
   ``groundstate``, then ``Evolution`` of the state "0101..." by
   ``method="expm"`` to t = 0.25, 0.5, 0.75, 1 after a warm-up on a copy,
   each call on a synchronised host clock. Gated: every operator and
   state tensor on the GPU, float64 for H and the ground state, complex128
   for the evolved state; the energy within 1e-10 relative of REFBASE's;
   each <Z_0>, from |psi|^2 on the card, within 1e-9 of REFBASE's; the
   final norm within 1e-10 of 1; the ELL ``SparseHam`` matvec within
   1e-12 relative of the ``LocalTermsHam`` one on a seeded vector.
   Printed: the matvec of each operator in float64 and complex128 (CUDA
   events) against the bound of reading x and writing H x once, the bytes
   the per-term loop moves, each term's time alone, the matvecs and
   Lanczos restarts of each call, and the busy share over one warm
   ``groundenergy`` and one expm update;
13. the 53-qubit depth-12 circuit of benchref/circuit53.py through
   ``Circuit.from_openqasm2_str`` with no device, once in complex128
   (quimb's dtype) and once in complex64 (the TPU bench's): ``amp0`` and
   the four amplitudes of benchref/measure_tpu_circuit53.py, each cold
   then warm on a synchronised host clock, the warm call split into the
   host rewrite (``rehearse=True``) and the contraction alone on the card.
   Gated: the circuit on the GPU; every pairwise step of an amplitude on
   CUDA tensors; each amplitude within 1e-9 (complex128) or 1e-3
   (complex64) relative of REFBASE's; ``sample(5, seed=42)`` in
   complex128 equal to quimb_tpu's strings, its steps on CUDA tensors;
   no sandwich kernel launched. Printed: each expression's flops, width
   and steps, ``amp0`` by ``backend="numpy"``, the busy share over one
   warm ``amp0`` and over ``sample(2)`` of a fresh circuit, and the
   sampler's groups by route.

14. (after phase 12) the MPS / MPO object layer on the float64 DMRG2
   state as a ``MatrixProductState`` on the card, with ``MPO_ham_heis``'s
   MPO: ⟨ψ|ψ⟩ and ⟨ψ|H|ψ⟩ by ``expec_TN_1D`` (the sandwich aligned by
   ``align_TN_1D``), within 1e-12 and 1e-10 of the float64 host sweep;
   ``schmidt_values`` and ``entropy`` at bonds 32, 64, 96 against a
   float64 host SVD of the same canonical tensor (1e-10); ``correlation``
   of S^z at (63, 64) and ``magnetization(64)`` against a host sweep;
   ``H.apply(psi)`` (bond 1280), ⟨Hψ|Hψ⟩ within 1e-8 of the host's ⟨H²⟩
   and a variance ≥ 0; its ``compress(max_bond=256, cutoff=0)``, with
   ⟨ψ|Hψ_c⟩ within |ψ| |Hψ − Hψ_c| of ⟨ψ|H|ψ⟩; ``sample(20, seed=42)``,
   each probability within 1e-10 relative of |amplitude|² / ⟨ψ|ψ⟩.
   Printed: each step's seconds, the peak allocation over H.apply and the
   compression, and the busy share over H.apply + the variance and over a
   window of the compression;
15. (after phase 13) the 53-qubit circuit as a ``CircuitMPS`` on the card
   (``from_openqasm2_str``, cutoff 1e-10, no bond limit), complex128 and
   complex64: the gates' seconds; in complex128 the bonds equal to
   quimb_tpu's, the five REFBASE amplitudes within 1e-5 relative and
   within 1e-7 of quimb_tpu's ``CircuitMPS`` (constants from
   ``scripts/circuit53_mps_samples.py``), ``sample(20, seed=42)`` equal
   to quimb_tpu's strings; in complex64 the amplitudes within 1e-3 of
   REFBASE. Printed: ``fidelity_estimate()`` and the busy share over the
   gates;
16. the 16x16 PEPS of benchref/measure_tpu_peps16.py (the Heisenberg
   model, D=3, chi=32), from the start arrays of
   scripts/peps16_reference.py (``default_rng(42)``), through ``PEPS``,
   ``ham_2d_heis`` and ``SimpleUpdate`` with no device: ``evolve(2,
   tau=0.3)``, then 30 fused steps at each of tau = 0.3, 0.1, 0.03, in
   float64 and in float32, then ``get_state().compute_local_expectation(
   ham.terms, max_bond=32)`` in float64. Gated against quimb_tpu's float64
   run of the same protocol from the same arrays (the constants and
   scripts/peps16_reference.json, from scripts/peps16_reference.py): the
   fused stacks on the card, the 480 gauge vectors within 1e-6, the
   energy per site within 1e-6, ``compute_energy_simple()`` within 1e-8
   relative; float32's ``compute_energy_simple()`` within 1e-4 relative
   of float64's; a 4x4 ``CircuitPEPS`` of depth 4 (U3 and CZ layers from a
   seeded stream, complex128, bond limit 64) within 1e-10 of the exact
   ``Circuit``'s five amplitudes; no sandwich kernel launched. Printed:
   seconds a step and host syncs a step (torch's sync debug mode), one
   class's bond split by the batched ``gesvdj`` (the path's), ``gesvd``
   and the matmul-only ``_topd_split`` with their accuracy, the class
   update's QRs and the rest, the energy's seconds and peak allocation,
   the busy share over a window of its environments, and the two
   artifacts' energies per site beside the result (not gated);
17. (after phase 14) complex DMRG on the card: the float64 DMRG2 state
   cast to complex128 and swept once at chi=256 by DMRG2 on a complex128
   ``MPO_ham_heis(128)`` built with no device, through the plain product
   (the dtype rule of ``resolve_sandwich``): the host energy within 1e-6
   relative of E_REF, no sandwich launch, the sweep's seconds and one bulk
   bond's breakdown beside phase 8's float64 bond; then complex128 DMRG1
   and ParallelDMRG at L=16, chi=32 on the card against the same runs on
   the CPU (1e-9 and 1e-6);
18. (after phase 16) the rings: (a) DMRG2 of ``MPO_ham_heis(150,
   cyclic=True)`` in float64 on the segmented ring engine (quimb_tpu's
   test ``test_cyclic_L150_segmented``: bonds 10, 12, 14, 16, 16, a third
   of the ring a segment, cutoff 1e-10): the energy within 1e-3 relative
   of ``heisenberg_energy(150)``, the state cyclic, every closure rank at
   most 128, <psi|psi> within 1e-2 of 1; seconds, closure ranks and host
   reads a sweep; (b) the first 5 steps of phase 10's quench on a 64-site
   ring (complex128, bond by bond): the 5 entropies within 1e-7 and
   ``err`` within 1e-2 relative of quimb_tpu's complex128 CPU run
   (``scripts/slice11_reference.py``); seconds a step;
19. the rest of the 2D layer: (a) phase 16's float64 state, scaled so
   that its norm is close to 1, contracted at chi=32 by the "mps" and
   "full-bond" boundaries and CTMRG (HOTRG at chi=16: at 32 its merges
   outgrow the card), each timed and held to the "mps" value and to
   quimb_tpu's value within 1e-8; (b)
   FullUpdate (ALS) and SimpleUpdate of the 4x4 Heisenberg model at D=3,
   chi=32 from ``default_rng(42)`` start arrays, 1 step at tau=0.3 then
   1 at 0.1: FullUpdate's energy below SimpleUpdate's and within 1e-8
   relative of quimb_tpu's; seconds and host syncs a gate, peak
   allocation;
20. (after phase 17) ``JacobiDMRG`` from the float64 DMRG2 state (L=128,
   chi=256), one sweep with the damped solves of quimb_tpu's own test of
   the engine (ncv=2): the state finite float64 on the card, its host
   <psi|psi> within 1e-8 of 1; printed, not gated, its host energy's
   distance from the DMRG2 start and from E_REF (the brickwork
   iteration's fixed point does not hold, in quimb_tpu as in the port),
   the sweep's seconds, peak allocation and the busy share over one
   half-sweep;
21. the arbitrary-geometry layer: (a) ``SimpleUpdateGen`` of the kagome
   Heisenberg antiferromagnet (``edges_2d_kagome(6, 6)``, 108 sites, D=4,
   float64, start arrays from ``default_rng(42)``, one step at each of
   tau = 0.3, 0.1, 0.03) through entry points with no device, its energy
   per site by ``compute_local_expectation(method="cluster")`` on gauges
   from ``gauge_all_simple(max_iterations=20)`` within 1e-6 relative of
   quimb_tpu's of the same protocol (``scripts/slice13_reference.py``);
   seconds a step, gates a second, host syncs a gate, busy share, peak
   allocation; (b) phase 16's state scaled to a norm near 1, its direct
   sum with itself (``add_PEPS``, checked block by block), and
   ``tensor_network_2d_compress`` by ``"local-early"`` and
   ``"superorthogonal"`` of the sum to bond 3 (timed and checked for its
   bond: its degenerate spectra make the kept half a matter of rounding)
   and of the state to bond 2, whose normalised overlap with the state by
   the boundary at chi=32 lies within 1e-8 relative of quimb_tpu's value;
   (c) <Z_q> of all 16 qubits of phase 16's
   circuit by ``CircuitPEPOSimpleUpdate`` at bond 8 (quimb_tpu's smallest
   exact bond) within 1e-10 of the port's ``Circuit``;
22. the 3D layer, through entry points with no device, held to quimb_tpu's
   float64 values from ``scripts/slice13_reference.py``: (a) the 3D
   classical Ising model at its critical coupling (beta = 0.2216544,
   ``TN3D_classical_ising_partition_function``): exact at 2x2x2 (against
   the sum over its 256 configurations) and 3x3x3 (1e-12), then
   ``contract_ctmrg(max_bond=16)`` at L=8, ``contract_boundary(
   max_bond=12)`` and ``contract_hotrg(max_bond=8)`` at L=6, each log Z
   within 1e-8 relative; seconds, peak allocation and ``compress_between``
   calls a second, and host syncs and the busy share over one plane of the
   L=8 CTMRG; (b) ``SimpleUpdate3D`` of the 3D Heisenberg model
   (``ham_3d_heis(4, 4, 4)``) on a 4x4x4 ``PEPS3D`` at D=3 from
   ``default_rng(42)``, two steps at each of tau = 0.3, 0.1, 0.03: the 144
   gauge vectors within 1e-6, the BP energy (``D2BP.local_expectation``
   over the 144 bonds) within 1e-6 relative; seconds a step, gates a
   second, host syncs a gate, and the boundary norm at max_bond 9 reckoned
   from its shapes, not run;
23. belief propagation: (a) ``D2BP`` on phase 16's float64 state: its
   norm estimate, the BP energy of the 480 bonds and the site norms of
   ``compress_d2bp(max_bond=2)`` (warm from the converged messages), each
   within 1e-8 relative, and the site norms of
   ``gauge_all_belief_propagation()`` of the 6^3 Ising network (on the
   signed 16x16 state its 1-norm BP never settles); iterations, host
   reads an iteration and the busy share over one iteration; (b) 1-norm BP
   on hyper networks: the 3D Ising model in a field h = 0.1
   (``HTN3D_classical_ising_partition_function``) by ``HV1BP`` at 8^3 and
   by ``D1BP`` and ``HV1BP`` at 4^3, and random 3-SAT counting
   (``HTN_random_ksat(3, 1000, alpha=3.0, seed=7)``) by ``HV1BP``, each log
   Z within 1e-8 relative of quimb_tpu's and the two engines within 1e-6
   of each other; iterations, seconds and host reads an iteration, shape
   groups, and the busy share over three HV1BP iterations;
24. optimisation and fitting, held to quimb_tpu's float64 values from
   ``scripts/slice14_reference.py``: (a) (after phase 14) H|psi> of the
   float64 DMRG2 state (bond 1280) compressed back to 256 (cutoff 1e-10)
   through
   ``tensor_network_1d_compress`` by ``dm``, ``fit``, ``src-oversample``,
   ``projector`` and ``bidm``, and by ``compress_all_1d`` of the
   contracted H|psi>: each infidelity 1 - F against the uncompressed
   H|psi> (exact overlaps by site sweeps on the card) within 10 (F_dm +
   (L / 32) F_rehearsal) of the method's own CPU rehearsal at L=32,
   chi=64, and each bond at most 256; seconds and peak allocation;
   (b) ``TNOptimizer`` on an L=128, chi=256 float64 MPS from
   ``default_rng(42)`` (normalised site by site), the Rayleigh quotient of
   the Heisenberg MPO contracted site by site (chi^3): 3 L-BFGS-B
   iterations, then 3 Adam steps, each loss within 1e-8 relative of
   quimb_tpu's sequence from the same arrays, L-BFGS-B's falling, the
   parameters on the card throughout; seconds an evaluation and the host
   bytes of scipy's vector; (c) ``ClusterUpdateGen`` (cluster distance
   1) on phase 21(a)'s kagome model from its start arrays at tau 0.3, as
   many steps as keep the sub-phase near 40 s (at least one, at most
   four): the
   energy per site by phase 21(a)'s estimator within 1e-8 relative of
   quimb_tpu's after as many steps; gates a second and host reads a gate;
25. (after phase 24(a)) the spectral estimates: the 10-site middle block
   of the DMRG2 state, canonized around it, as the network of rho_A (ket
   and bra block tensors, the boundary bonds joined) and a
   ``TNLinearOperator``: Tr rho log2 rho by
   ``tensor_network_approx_spectral_function`` (1024 probes batched in one
   product) within the estimator's stopping rule (tol x scale) of the
   exact value from ``eigvalsh`` of the dense 1024 x 1024 rho
   (``to_dense`` on the card); ``rsvd(rho, 16, p=8)`` against
   ``torch.linalg.svdvals`` within ten times quimb_tpu's own distance on
   the rehearsal's matrix;
26. (after phase 27) exact diagonalisation in a symmetry sector: the
   Heisenberg antiferromagnet (``heisenberg_from_edges``) on the 4 x 4 and
   4 x 6 tori in the U1 sector of half filling, as the matrix-free
   ``CoupledHam`` (``build_coupled_ham``): at 4 x 4 (D=12,870) the
   ``groundenergy`` within 1e-10 relative of the exact
   -11.228483208428864 and the matvec within 1e-12 of the ELL
   ``build_sparse_ham()`` on the card; at 4 x 6 (D=2,704,156) the
   ``groundenergy`` within 1e-10 relative of quimb_tpu's (its sector
   matrix and scipy's eigsh, ``scripts/slice15_reference.py``) and the
   ``groundstate``'s Ritz residual at most 1e-6; D, the terms per arity,
   the matvecs to convergence, one matvec's time (median of 5 CUDA-event
   timings), its launches (``torch.profiler``), its bound (24 B x D over
   the card's bandwidth) and share, a Lanczos restart's busy share and
   the peak allocation;
27. (after phase 11) the dense matrix half on phase 11's N=20 ground state
   (by Lanczos to machine precision): ``entropy_subsys``,
   ``mutinf_subsys``, ``logneg_subsys`` (a 4096 x 4096 rho_AB),
   ``schmidt_gap``, ``concurrence`` and ``pauli_correlations``, each within
   1e-10 absolute of quimb_tpu's; ``Evolution(method="integrate")`` over
   phase 11's protocol, <Z_0> within 1e-10 of quimb_tpu's RK45 and within
   1e-8 of REFBASE and phase 11's expm path, with its steps and host
   reads; an N=10 density operator under the Lindblad equation (dephasing
   on every site, gamma = 0.1, to t = 1) and by ``method="solve"``, <Z_i>,
   purity and the diagonal within 1e-8 relative of quimb_tpu's;
28. ``CircuitDense`` at 28 qubits in complex128 (4.3 GB): the gates of
   ``circ_ansatz_1D_brickwork(28, 8, seed=7)`` applied eagerly, the norm
   within 1e-12 of 1, the amplitudes of ``sample(4, seed=42)``'s strings
   and <ZZ> on qubits 13, 14 within 1e-10 of the lazy ``Circuit``'s; the
   seconds a gate, the draw's seconds and the peak allocation; then
   ``xeb`` of those strings, which copies no more than 4 KiB from the card
   (``torch.profiler``'s device-to-host bytes over the call, its
   recording of copies proved by a 1 MiB control copy), and
   ``simulate_counts(4, seed=42)``, equal to the counts of the strings
   ``sample`` drew from the same |psi|^2 with the same seed, each timed;
29. (last) variational Monte Carlo, CTMRG and marginals, held to quimb_tpu's
   float64 values from ``scripts/slice16_reference.py``: (a) ``TNVMC`` on
   the 6 x 6 open-boundary Heisenberg PEPS at D=4 (10,368 parameters, a
   SimpleUpdate state of quimb_tpu's) with 128 exchange chains: for 128
   fixed S^z = 0 configurations the amplitudes (also against the port's
   own ``isel`` + ``contract`` at 1e-12), local energies, ``O @ v``, one
   SR update's energy and ``|delta|`` within 1e-10 relative of quimb_tpu's,
   and ``delta`` within 10 cond(S) eps (its solve's forward error); (b) the
   exchange sampler's estimate of the state's energy after 2,000, 10,000
   and 20,000 proposal steps a chain (replays of one CUDA graph), the last
   within max(5 sigma, 3 %) of
   quimb_tpu's boundary contraction at chi = 64, then three SR
   steps, each timed and broken into sampling, local energies, gradients
   and the solve, with host reads, the peak allocation and the busy share
   of a step, none rising more than 3 sigma above the start; (c)
   ``ctmrg_partition_function`` of the 2D Ising model at beta_c, L = 256,
   ``max_bond`` 32: log10 Z within 1e-10 relative of quimb_tpu's; (d)
   ``compute_all_marginals_via_autodiff`` of every bond of phase 22's
   3 x 3 x 3 Ising network against ``..._via_slicing`` within 1e-10. No
   phase from 17 to 29 launches a sandwich kernel;
30. the multi-device layer (``quimb_torch.parallel``) in a one-rank NCCL
   world on the card (NCCL runs no two ranks on one GPU): (a) (after phase
   20) one DMRG2 sweep of the float64 L=128, chi=256 state under
   ``shard_onto(get_mesh_2d())`` against one unsharded sweep, each from
   its own copy, energies within 1e-12 relative, the sharded sweep
   launching ``sandwich_f64`` at least ncv * restarts * (L - 1) times and
   its environments DTensors on the card; the same on a float32 copy with
   ``sandwich_tf32``; the busy share of one sharded sweep and the NCCL
   kernels' share of it; (b) (last) ``ShardedSparseHam(ham_heis(20))``'s
   matvec against ``SparseHam`` at 1e-12, ``eigh_lanczos_sharded``
   against REFBASE at 1e-10 and ``expm_multiply_sharded`` over phase 11's
   protocol against its <Z_0> at 1e-9; (c) phase 13's amplitude network
   by ``contract_sliced`` over 16 slices batched on the card, and
   ``amplitude(mesh=)``, against REFBASE at 1e-9, and ``sample(2,
   seed=42, mesh=)`` against the unsharded per-sample draw; (d) phase 10's
   complex128 quench, 4 steps under ``TEBD.shard_onto(get_mesh())``
   against 4 unsharded, entropies within 1e-12; (e)
   ``approx_spectral_sharded`` of tr(H^2) on (b)'s operator against the
   unsharded ``construct_lanczos_tridiag`` on the same probes at 1e-10;
   (f) ``dryrun_multichip(1)``; (g) ``DMRGX`` at L=12 (chi 8, two
   sweeps from the Neel state) under ``shard_onto(get_mesh_2d())``, every
   rank sweeping the whole chain, equal to the unsharded sweeps to the
   last bit (quimb_tpu's ring raises under ``shard_onto``, so no ring is
   sharded), and ``SpinHam1D(S=1/2).build_dense(12)`` on the card against
   ``build_sparse(12)`` at 1e-12. Each part's seconds, and the card's
   name and power limit. Phases 28(xeb, counts) and 30(g) launch no
   sandwich kernel: this slice adds no kernel launch.

The line before the last is the kernels' JSON summary, one entry per
kernel with its launches on its paths (DMRG2, ParallelDMRG and the
sharded sweep of phase 30(a) for float32; DMRG2, DMRG1 and the sharded
sweep for float64; TEBD runs no hand-written kernel),
its time against the plain einsum (the one library call that computes
the same product) and its bound. The exact core runs no hand-written
kernel: its matvec is plain PyTorch, measured in phase 11; nor do the
circuit, the MPS layer and the PEPS: quimb_tpu's have no Pallas kernel,
and their products run as batched ``matmul``, QR and SVD on the card;
nor do complex DMRG, the rings, HOTRG, CTMRG, FullUpdate, JacobiDMRG,
the arbitrary-geometry layer, the 3D layer, belief propagation, the
optimizer, the fits, the cluster update, the spectral estimates, the
sector operator, calc, Evolution's RK45, CircuitDense and VMC (quimb_tpu runs
them on its einsum, gathers, QR, SVD, Cholesky and eigh; HV1BP's
batched updates are ``torch.einsum`` over stacked tensors, as quimb_tpu's
are ``jax.vmap`` of einsums). The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import json
import math
import re
import statistics
import subprocess
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import quimb_torch
from quimb_torch import core
from quimb_torch.ops import _build
from quimb_torch.ops import cuda_kernels as ck
from quimb_torch.ops import decomp
from quimb_torch.ops.backend import numpy_dtype, to_host
from quimb_torch.tensor.tn1d import dmrg as D
from quimb_torch.tensor.tn1d.dmrg_parallel import ParallelDMRG
from quimb_torch.tensor.tn2d import su_fused

L, CHI, P0_BOND, SEED = 128, 256, 32, 42
R_SCHEDULE = (64, 128, 256, 256, 256)
# converged float64 DMRG2 energy of this chain (bench.py:392) and the
# bench's acceptance bounds on the relative error for a float32 and a
# float64 state (bench.py:402)
E_REF = -56.535467821834
E_REL_TOL = {torch.float32: 2e-5, torch.float64: 1e-6}
# (w, M, K1, K2, N): the bulk bond at chi=256, the 1-site (DMRG1) bond,
# bonds next to a chain end (the end itself has M = K1 = 2), a ragged
# shape that leaves partial tiles on every edge, and 1 x 1 bonds
CHECK_SHAPES = ((5, 512, 512, 512, 512), (5, 512, 512, 256, 256),
                (5, 4, 4, 512, 512), (5, 2, 2, 512, 512),
                (5, 130, 66, 98, 34), (1, 1, 1, 1, 1))
# relative Frobenius error against float64: accumulation over depths of
# 512 and 5 * 512, in 3xTF32 for float32 and on the FP64 tensor cores for
# float64
KERNEL_TOLS = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNEL_NAME = {torch.float32: "sandwich_tf32", torch.float64: "sandwich_f64"}
KERNEL_SOURCE = {torch.float32: "quimb_torch/csrc/sandwich_tf32.cu",
                 torch.float64: "quimb_torch/csrc/sandwich_f64.cu"}
KERNEL_KIND = {torch.float32: "3xTF32", torch.float64: "FP64 DMMA"}
# the card's peak rates for each kernel's work (NVIDIA's data sheet, H100
# SXM, 700 W): 3xTF32 does three TF32 products per float32 product, so
# 495 / 3 TFLOP/s of float32 work; float64 on the FP64 tensor cores
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.float64: 67e12}
PEAK_BYTES = 3.35e12


def check_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)


def build_kernels():
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s ({lib})",
          flush=True)
    log = (lib.parent / "build.log").read_text()
    print(log, flush=True)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", log)
    if not spills or any(n != "0" for pair in spills for n in pair):
        raise AssertionError("ptxas reports spills (or no spill report)")
    # the float64 kernel's products must run on the FP64 tensor cores
    # (DMMA), not on the FMA pipes (DFMA)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    dmma = re.findall(r"\bDMMA\.\S+", sass)
    dfma = re.findall(r"\bDFMA\b", sass)
    print(f"SASS: {len(dmma)} DMMA instructions {sorted(set(dmma))}, "
          f"{len(dfma)} DFMA", flush=True)
    if not dmma:
        raise AssertionError("the float64 kernel's SASS holds no DMMA")


def _cuda(x, dtype):
    return torch.as_tensor(x, dtype=dtype, device="cuda")


def _event_ms(fn, args, reps=50):
    for _ in range(5):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _rel_err(got, ref):
    return (torch.linalg.norm(got.double() - ref)
            / torch.linalg.norm(ref)).item()


def check_kernel():
    """Kernels vs plain version at every check shape, with bitwise
    repeatability; returns ({dtype: max_abs_err at the north-star shape},
    its host operands)."""
    rng = np.random.default_rng(SEED)
    max_abs_err, north = {}, None
    for shape in CHECK_SHAPES:
        w, M, K1, K2, N = shape
        host = (rng.standard_normal((w, M, K1)),
                rng.standard_normal((K1, K2)),
                rng.standard_normal((w, K2, N)))
        ref = ck.sandwich_matvec_reference(
            *(_cuda(x, torch.float64) for x in host)
        )
        for dtype, tol in KERNEL_TOLS.items():
            a, theta, b = (_cuda(x, dtype) for x in host)
            before = ck.LAUNCHES[KERNEL_NAME[dtype]]
            heff = ck.resolve_sandwich("cuda", dtype)(a, b)
            got, again = heff(theta), heff(theta)
            one_shot = ck.sandwich_matvec(a, theta, b)
            torch.cuda.synchronize()
            if ck.LAUNCHES[KERNEL_NAME[dtype]] != before + 3:
                raise AssertionError("the kernel's launch count is off")
            rel = _rel_err(got, ref)
            same = torch.equal(got, again) and torch.equal(got, one_shot)
            print(f"kernel {dtype} {shape}: relative error {rel:.3e} "
                  f"(tolerance {tol:.0e}), bitwise repeatable {same}",
                  flush=True)
            if not rel <= tol:
                raise AssertionError(f"sandwich kernel disagrees at "
                                     f"{shape} {dtype}: {rel:.3e}")
            if not same:
                raise AssertionError(f"sandwich kernel not repeatable at "
                                     f"{shape} {dtype}")
            if shape == CHECK_SHAPES[0]:
                max_abs_err[dtype] = (got.double() - ref).abs().max().item()
                north = host
    return max_abs_err, north


# the launches of one matvec, by kernel name, demangled or not
TF32_LAUNCHES = (("split theta", ("split_transpose",)),
                 ("pass 1", ("gemm_3xtf32<true>", "gemm_3xtf32ILb1E")),
                 ("pass 2", ("gemm_3xtf32<false>", "gemm_3xtf32ILb0E")),
                 ("sum over x", ("sum_partials",)))
F64_LAUNCHES = (("pad theta", ("pad_transpose_f64",)),
                ("passes 1 and 2", ("gemm_dmma",)),
                ("sum over x", ("sum_partials_f64",)))
LAUNCH_STEPS = {torch.float32: TF32_LAUNCHES, torch.float64: F64_LAUNCHES}


def _launch_device_ms(heff, theta, steps, reps=20):
    """Device ms per matvec of each step of ``steps``, from
    torch.profiler; None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            heff(theta)
        torch.cuda.synchronize()
    events = prof.key_averages()
    times = {}
    for step, names in steps:
        total = sum(getattr(ev, "device_time_total", 0) or 0
                    for ev in events if any(n in ev.key for n in names))
        times[step] = total / 1e3 / reps if total > 0 else None
    return times


def time_kernel(host, dtype):
    """CUDA-event times at the north-star shape; returns (kernel ms,
    plain ms) of the matvec in ``dtype``."""
    a, theta, b = (_cuda(x, dtype) for x in host)
    heff = ck.prepare_sandwich(a, b)
    # plain, kernel, kernel, plain on the same operands
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "plain":
            times[name].append(_event_ms(ck.sandwich_matvec_reference,
                                         (a, theta, b)))
        else:
            times[name].append(_event_ms(heff, (theta,)))
    flop = sandwich_bound(dtype)[2]
    kernel_ms = statistics.mean(times["kernel"])
    plain_ms = statistics.mean(times["plain"])
    print(f"sandwich at {CHECK_SHAPES[0]} {dtype}: kernel (prepared, "
          f"{KERNEL_KIND[dtype]}) {times['kernel']} ms "
          f"({flop / kernel_ms / 1e9:.2f} TFLOP/s), plain einsum "
          f"{times['plain']} ms ({flop / plain_ms / 1e9:.2f} TFLOP/s)",
          flush=True)
    prep_ms = _event_ms(ck.prepare_sandwich, (a, b), reps=20)
    print(f"  prepare step, once per local solve: {prep_ms:.4f} ms",
          flush=True)
    steps = _launch_device_ms(heff, theta, LAUNCH_STEPS[dtype])
    for step, ms in steps.items():
        print(f"  {step}: " + ("device time not measured" if ms is None
                               else f"{ms:.4f} ms device time"),
              flush=True)
    if all(steps.values()):
        print(f"  all launches: {sum(steps.values()):.4f} ms device time "
              f"per matvec", flush=True)
    return kernel_ms, plain_ms


def sandwich_bound(dtype):
    """(ms, "bytes" or "operations", flop): the least time of one matvec
    at the north-star shape, the larger of its operands' and result's
    bytes over the memory rate and its products over the peak rate."""
    w, M, K1, K2, N = CHECK_SHAPES[0]
    flop = 2 * w * (M * K1 * K2 + M * K2 * N)
    nbytes = (w * M * K1 + K1 * K2 + w * K2 * N + M * N) * dtype.itemsize
    ops_ms = flop / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), flop


def _arrays(x):
    """The uniform site arrays of an MPS, (l, p, r), or of an MPO,
    (wl, wr, u, d), the chain's ends padded with size-1 bonds; a list of
    such arrays as it is."""
    if isinstance(x, list):
        return x
    if isinstance(x, quimb_torch.MatrixProductOperator):
        return D._mpo_uniform_arrays(x)
    return D._mps_uniform_arrays(x)


def host_f64_energy(psi, H):
    """⟨ψ|H|ψ⟩/⟨ψ|ψ⟩ of the MPS under the MPO in float64 numpy
    (bench.py:333-348)."""
    energy, norm = host_f64_sweep(psi, H)
    return energy / norm


def host_f64_sweep(psi, H):
    """(⟨ψ|H|ψ⟩, ⟨ψ|ψ⟩) of the MPS under the MPO by the sweep of
    bench.py:333-348, in float64 numpy on the host."""
    env = np.ones((1, 1, 1))
    nrm = np.ones((1, 1))
    for A, W in zip(_arrays(psi), _arrays(H)):
        Ah = to_host(A).astype(np.float64)
        Wh = to_host(W).astype(np.float64)
        env = np.einsum("bwk,kdx->bwdx", env, Ah, optimize=True)
        env = np.einsum("bwdx,wyud->byux", env, Wh, optimize=True)
        env = np.einsum("byux,bua->ayx", env, Ah.conj(), optimize=True)
        nrm = np.einsum("bk,kdx->bdx", nrm, Ah, optimize=True)
        nrm = np.einsum("bdx,bda->ax", nrm, Ah.conj(), optimize=True)
    return float(env.reshape(())), float(nrm.reshape(()))


def run_main_path(dtype):
    """The DMRG2 main path on a state of ``dtype``; returns (dmrg, its
    kernel's launches)."""
    H = quimb_torch.MPO_ham_heis(L, dtype=dtype, device="cuda")
    p0 = quimb_torch.MPS_rand_state(L, P0_BOND, seed=SEED, dtype=dtype,
                                    device="cuda")
    dmrg = quimb_torch.DMRG2(H, bond_dims=CHI, cutoffs=0.0, p0=p0)
    opts = dmrg.opts
    _check_default_split(dmrg, "DMRG2")
    min_launches = (max(2 * opts["local_eig_ncv"],
                        opts["local_eig_ncv_floor"])
                    * opts["local_eig_restarts"] * (L - 1))
    sweeps = [("R", mb) for mb in R_SCHEDULE] + [("L", CHI)]
    kernel = KERNEL_NAME[dtype]

    _reset_launches()
    t_path = time.perf_counter()
    for direction, max_bond in sweeps:
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        en = dmrg.sweep(direction, max_bond=max_bond, cutoff=0.0,
                        canonize=direction == "R")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dmrg.energies.append(en)
        n = _sweep_launches(kernel, before, min_launches, "DMRG2 sweep")
        print(f"{dtype} sweep {direction} max_bond={max_bond}: {dt:.3f} s, "
              f"energy {en:.10f}, sandwich launches {n}", flush=True)
    launches = ck.LAUNCHES[kernel]
    print(f"{dtype} main path: {time.perf_counter() - t_path:.3f} s, "
          f"sandwich launches {dict(ck.LAUNCHES)}", flush=True)

    state = dmrg.state
    if not isinstance(state, quimb_torch.MatrixProductState):
        raise AssertionError(f"DMRG2.state is a {type(state)}, not an MPS")
    for A in _arrays(state):
        if not (A.shape[0] <= CHI and A.shape[2] <= CHI and A.dtype == dtype
                and A.is_cuda and bool(torch.isfinite(A).all())):
            raise AssertionError(f"bad site tensor {tuple(A.shape)}")
    _check_energy(state, dmrg.ham, dtype,
                  f"{dtype} DMRG2 state (last sweep energy "
                  f"{dmrg.energies[-1]:.10f})")
    return dmrg, launches


def _check_default_split(dmrg, what):
    """The engine on the card must split by quimb_tpu's accelerator
    default, "svd:sub" ("svd:sub0" at cutoff 0)."""
    method = dmrg.opts["bond_compress_method"]
    print(f"{what} bond_compress_method {method!r}, at cutoff 0 "
          f"{dmrg._split_method(0.0)!r}", flush=True)
    if method != "svd:sub":
        raise AssertionError(f"{what} on the card splits by {method!r}")


def _host_ms(fn, reps=5):
    """Median wall ms of ``fn()`` bracketed by device synchronisation."""
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out[1:])


def _mixed_canonical_bond(dmrg, i):
    """The environments and two-site tensor of bond (i, i + 1) with the
    orthogonality center there, as a right sweep meets it: the state
    after a left sweep is right-canonical, and QR moves its center from
    site 0 to site i. Returns (lenv, renv, theta0)."""
    As = list(dmrg._A)
    for j in range(i):
        l, p, r = As[j].shape
        Q, _, Rf = decomp.qr_stabilized(As[j].reshape(l * p, r))
        As[j] = Q.reshape(l, p, Q.shape[-1])
        As[j + 1] = torch.einsum("ck,kpr->cpr", Rf, As[j + 1])
    lenv = dmrg._ones_env()
    for j in range(i):
        lenv = D._env_step_right(lenv, torch.conj(As[j]), dmrg._W[j], As[j])
    renv = dmrg._ones_env()
    for j in range(L - 1, i + 1, -1):
        renv = D._env_step_left(renv, torch.conj(As[j]), dmrg._W[j], As[j])
    return lenv, renv, torch.einsum("kpc,cqr->kpqr", As[i], As[i + 1])


def bond_breakdown(dmrg):
    """Wall time of each phase of one bulk bond update at chi=256;
    returns the updated two-site tensor."""
    i = L // 2
    lenv, renv, theta0 = _mixed_canonical_bond(dmrg, i)
    W1, W2 = dmrg._W[i], dmrg._W[i + 1]
    kw = dmrg._solve_opts()
    _, theta = D._local_solve_2site(lenv, W1, W2, renv, theta0, **kw)
    method = dmrg._split_method(0.0)
    N1, _, _ = D._split_2site(theta, CHI, 0.0, "right", method=method)
    A, B = D._sandwich_operands(lenv, W1, W2, renv)
    th = theta.reshape(A.shape[2], B.shape[1])
    mat = theta.reshape(A.shape[1], B.shape[2])
    T = torch.diag(torch.linspace(-1, 1, kw["ncv"], device=theta.device))
    heff = ck.prepare_sandwich(A, B)
    phases = {
        "local solve (operands + prepare + Lanczos + eigh)": lambda: (
            D._local_solve_2site(lenv, W1, W2, renv, theta0, **kw)),
        "  sandwich operands": lambda: D._sandwich_operands(
            lenv, W1, W2, renv),
        "  sandwich prepare (once per solve)": lambda: ck.prepare_sandwich(
            A, B),
        f"  one sandwich matvec ({kw['ncv']} per solve)": lambda: heff(th),
        f"  eigh {kw['ncv']}x{kw['ncv']}": lambda: torch.linalg.eigh(T),
        f"split (the path's, {method})": lambda: D._split_2site(
            theta, CHI, 0.0, "right", method=method),
        "split (masked SVD, svd)": lambda: D._split_2site(theta, CHI, 0.0,
                                                          "right"),
        f"  torch.linalg.svd {tuple(mat.shape)}, gesvd": lambda: (
            torch.linalg.svd(mat, full_matrices=False, driver="gesvd")),
        "env step": lambda: D._env_step_right(lenv, torch.conj(N1), W1,
                                              N1),
    }
    print(f"bulk bond {i} (theta {tuple(theta0.shape)}, {theta0.dtype}), "
          f"median wall ms:", flush=True)
    for name, fn in phases.items():
        print(f"  {name}: {_host_ms(fn):.3f}", flush=True)
    return theta


# (method, cutoff) of each split; "svd" at both cutoffs is the reference
# of the methods at the same cutoff ("svd:sub0" has none: it keeps max_bond)
SPLITS = (("svd", 0.0), ("svd", 1e-10), ("svd:eig", 0.0),
          ("svd:sub", 1e-10), ("svd:sub0", 0.0))
# ||U^T U - I||_2 (the spectral norm: how far the kept columns are from
# an isometry, whatever their count) of the isometric factor
ORTHO_TOLS = {torch.float32: 1e-4, torch.float64: 1e-10}


def check_splits(theta):
    """Each split method at one updated bulk theta, absorb "right" (A1
    isometric): median wall ms, relative residual ||theta - A1 A2|| /
    ||theta|| and orthogonality of A1, with the gates of phase 6."""
    dtype = theta.dtype
    th = theta.double()
    res = {}
    print(f"splits of theta {tuple(theta.shape)} {dtype} to max_bond {CHI}, "
          f"absorb right:", flush=True)
    for method, cutoff in SPLITS:
        split = functools.partial(D._split_2site, theta, CHI, cutoff, "right",
                                  method=method)
        A1, A2, rank = split()
        ms = _host_ms(split)
        r = int(rank)
        finite = bool(torch.isfinite(A1).all()) and bool(
            torch.isfinite(A2).all())
        prod = torch.einsum("kpc,cqr->kpqr", A1.double(), A2.double())
        res[method, cutoff] = (torch.linalg.norm(th - prod)
                               / torch.linalg.norm(th)).item()
        # the kept columns: the mask zeroes the others
        U = A1.reshape(-1, A1.shape[-1]).double()
        nonzero = torch.linalg.norm(U, dim=0) > 0
        U = U[:, nonzero]
        kept = U.shape[1]
        E = U.T @ U - torch.eye(kept, dtype=U.dtype, device=U.device)
        orth = torch.linalg.matrix_norm(E, 2).item()
        print(f"  {method} (cutoff {cutoff:g}): {ms:.3f} ms, rank {r}, "
              f"last kept column {int(torch.nonzero(nonzero).max()) + 1}, "
              f"residual {res[method, cutoff]:.6e}, ||U^T U - I|| "
              f"{orth:.3e} (2-norm), {torch.linalg.norm(E).item():.3e} "
              f"(Frobenius), finite {finite}", flush=True)
        if kept != r:
            raise AssertionError(f"split {method}: rank {r} but {kept} "
                                 f"nonzero columns")
        if not finite:
            raise AssertionError(f"split {method}: factors not finite")
        if not orth <= ORTHO_TOLS[dtype]:
            raise AssertionError(f"split {method}: isometric factor off by "
                                 f"{orth:.3e}")
    if dtype != torch.float64:
        return
    # float64 only: the float32 gram matrix loses the values below
    # sqrt(eps) s_0, a property of the method (printed, not gated). In
    # float64 that floor is sqrt(eps) = 1.5e-8 relative: a bound never
    # asks a gram-matrix method for less than gesvd's residual plus it
    floor = torch.finfo(torch.float64).eps ** 0.5

    def bound(factor, cutoff):
        return max(factor * res["svd", cutoff], res["svd", cutoff] + floor)

    if not res["svd:eig", 0.0] <= bound(1.01, 0.0):
        raise AssertionError("svd:eig's residual exceeds gesvd's by > 1 %")
    for key in (("svd:sub", 1e-10), ("svd:sub0", 0.0)):
        if not res[key] <= bound(2, key[1]):
            raise AssertionError(f"{key[0]}'s residual exceeds twice "
                                 f"gesvd's")


def _reset_launches():
    torch.cuda.synchronize()
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0


def _sweep_launches(kernel, before, at_least, what):
    """The launches since ``before``, by kernel; fails unless ``kernel``
    has at least ``at_least`` and no other kernel has any."""
    n = {k: ck.LAUNCHES[k] - before[k] for k in before}
    if n[kernel] < at_least or sum(n.values()) != n[kernel]:
        raise AssertionError(f"{what} launched the kernels {n}; {kernel} "
                             f"fewer than {at_least} times, or another "
                             f"kernel")
    return n


def _check_energy(state, H, dtype, what):
    """The host float64 energy of the MPS ``state`` against E_REF."""
    t0 = time.perf_counter()
    e64 = host_f64_energy(state, H)
    rel = abs(e64 - E_REF) / abs(E_REF)
    tol = E_REL_TOL[dtype]
    print(f"{what}: float64 host energy {e64:.10f} "
          f"({time.perf_counter() - t0:.1f} s): delta {e64 - E_REF:.3e}, "
          f"relative {rel:.3e} (bound {tol:.0e})", flush=True)
    if not rel < tol:
        raise AssertionError(f"{what}: energy {e64} misses E_REF {E_REF}")
    return e64


PAR_SEGMENTS, PAR_NCV, PAR_INNER, PAR_SWEEPS = 2, 8, 3, 2


def run_parallel_path(dmrg2):
    """ParallelDMRG from the float32 DMRG2 state (bench.py:239-245);
    returns its float32 kernel launches."""
    H = dmrg2.ham
    pd = ParallelDMRG(dmrg2.state, H, max_bond=CHI, n_segments=PAR_SEGMENTS,
                      ncv=PAR_NCV, inner_passes=PAR_INNER)
    _reset_launches()
    t_path = time.perf_counter()
    for _ in range(PAR_SWEEPS):
        # the segments of this outer sweep: the offset alternates by half
        # a segment (ParallelDMRG.sweep)
        off = (pd.m // 2) * (pd._phase % 2)
        n_seg = len(range(off, pd.L - pd.m + 1, pd.m))
        at_least = (2 * PAR_INNER + 1) * n_seg * (pd.m - 1) * PAR_NCV
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        en = pd.sweep()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = _sweep_launches("sandwich_tf32", before, at_least,
                            "parallel outer sweep")
        print(f"ParallelDMRG outer sweep (offset {off}, {n_seg} segments): "
              f"{dt:.3f} s, energy {en:.10f}, sandwich launches {n} "
              f"(at least {at_least})", flush=True)
    launches = ck.LAUNCHES["sandwich_tf32"]
    print(f"ParallelDMRG path: {time.perf_counter() - t_path:.3f} s, "
          f"sandwich launches {dict(ck.LAUNCHES)}", flush=True)
    state = pd.get_state()
    for A in _arrays(state):
        if not bool(torch.isfinite(A).all()):
            raise AssertionError(f"bad site tensor {tuple(A.shape)}")
    _check_energy(state, H, torch.float32, "ParallelDMRG float32 state")
    return launches


def run_dmrg1_path(dmrg2):
    """DMRG1 from the float64 DMRG2 state; returns its float64 kernel
    launches."""
    H = dmrg2.ham
    e2 = host_f64_energy(dmrg2.state, H)
    dmrg = quimb_torch.DMRG1(H, bond_dims=CHI, cutoffs=0.0, p0=dmrg2.state)
    _check_default_split(dmrg, "DMRG1")
    opts = dmrg.opts
    ncv = max(2 * opts["local_eig_ncv"], opts["local_eig_ncv_floor"])
    _reset_launches()
    t_path = time.perf_counter()
    for direction in "RL":
        # one launch per Lanczos vector; the basis stops at the dimension
        # of the one-site space, 4 at a chain end
        at_least = opts["local_eig_restarts"] * sum(
            min(ncv, A.numel()) for A in dmrg._A)
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        en = dmrg.sweep(direction, max_bond=CHI, cutoff=0.0,
                        canonize=direction == "R")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = _sweep_launches("sandwich_f64", before, at_least, "DMRG1 sweep")
        print(f"DMRG1 sweep {direction} max_bond={CHI}: {dt:.3f} s, energy "
              f"{en:.10f}, sandwich launches {n} (at least {at_least})",
              flush=True)
    launches = ck.LAUNCHES["sandwich_f64"]
    print(f"DMRG1 path: {time.perf_counter() - t_path:.3f} s, sandwich "
          f"launches {dict(ck.LAUNCHES)}", flush=True)
    e1 = _check_energy(dmrg.state, H, torch.float64, "DMRG1 float64 state")
    rise = (e1 - e2) / abs(e2)
    print(f"DMRG1 energy against the DMRG2 state's {e2:.10f}: relative "
          f"change {rise:.3e} (rise bound 1e-9)", flush=True)
    if not rise <= 1e-9:
        raise AssertionError("DMRG1 raised the DMRG2 state's energy")
    return launches


# -- phase 12: the tensor-network layer on the north-star state --------------

# bounds, relative: the <psi|psi> contraction against the host sweep (two
# float64 sums over 256 tensors in different orders); each route's energy
# ratio against the host sweep's; the pair's product after the compression
# against the rank-128 truncation of the fused pair by torch.linalg.svd;
# and the ket's norm across the canonisation (a QR and its product)
TN_NORM_TOL, TN_ENERGY_TOL, TN_SPLIT_TOL, TN_CANON_TOL = (1e-12, 1e-10,
                                                          1e-10, 1e-12)
TN_BOND, TN_MAX_BOND = 64, 128


def _tn_scalar(x):
    """A full contraction's value as a Python float: a scalar tensor, or a
    tensor whose remaining indices (the MPO's size-1 ends) have size 1."""
    data = x.data if isinstance(x, quimb_torch.Tensor) else x
    return float(data.reshape(()))


def _tn_networks(As, Ws):
    """The ket, operator and bra networks of <psi|H|psi>, built through
    the public API as make_overlap builds them: the bra is the ket's
    conjugate with its inner indices mangled and its physical indices
    renamed p -> q, the operator's upper indices."""
    Tensor, TensorNetwork = quimb_torch.Tensor, quimb_torch.TensorNetwork
    ket = TensorNetwork([
        Tensor(A, inds=(f"k{i}", f"p{i}", f"k{i + 1}"),
               tags={f"I{i}", "KET"}) for i, A in enumerate(As)])
    ham = TensorNetwork([
        Tensor(W, inds=(f"h{i}", f"h{i + 1}", f"q{i}", f"p{i}"),
               tags={f"I{i}", "HAM"}) for i, W in enumerate(Ws)])
    bra = ket.conj(mangle_inner=True).reindex(
        {f"p{i}": f"q{i}" for i in range(len(As))})
    bra.retag_({"KET": "BRA"})
    return ket, ham, bra


def _tn_search(tn, optimize, output_inds=None):
    """The contraction expression of ``tn`` and the host seconds of its
    path search (a fresh search, not a cache hit)."""
    from quimb_torch.ops import contraction as C

    C._EXPR_CACHE.clear()
    t0 = time.perf_counter()
    info = tn.contraction_info(output_inds, optimize)
    return info, time.perf_counter() - t0


def _tn_timed(fn, reps=3):
    """(result, seconds): a warm call, then the median of ``reps`` calls
    on a synchronised host clock."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def _tn_counted(fn):
    """(flops, width) of the contractions ``fn`` runs: the sum of each
    call's path cost and the largest width, from the expression of every
    array_contract call, without changing what runs."""
    from quimb_torch.ops import contraction as C
    from quimb_torch.tensor import core as tcore

    flops, width = [0.0], [0.0]
    plain = tcore.array_contract

    def counted(arrays, inputs, output=None, **kwargs):
        out = C.find_output_inds(inputs) if output is None else output
        expr = C.array_contract_expression(
            inputs, out, shapes=[a.shape for a in arrays],
            optimize=kwargs.get("optimize"))
        flops[0] += expr.flops
        width[0] = max(width[0], expr.width)
        return plain(arrays, inputs, output, **kwargs)

    tcore.array_contract = counted
    try:
        fn()
    finally:
        tcore.array_contract = plain
    return flops[0], width[0]


def _tn_report(what, info, search_s, secs):
    print(f"{what}: path search {search_s:.3f} s, flops {info.flops:.4e}, "
          f"width {info.width:.2f}, {secs:.4f} s warm (median of 3), "
          f"{info.flops / secs / 1e12:.3f} TFLOP/s", flush=True)


def run_tn_layer(dmrg):
    """The tensor-network object layer on the float64 DMRG2 state: the
    norm and energy networks of the L=128, chi=256 state contracted by
    three routes, and a canonisation and compression at bond 64."""
    from quimb_torch.ops.native import native_available

    t_phase = time.perf_counter()
    As = _arrays(dmrg.state)
    Ws = _arrays(quimb_torch.MPO_ham_heis(L, dtype=torch.float64,
                                          device="cuda"))
    _reset_launches()
    before = dict(ck.LAUNCHES)
    ket, ham, bra = _tn_networks(As, Ws)
    for name, tn in (("ket", ket), ("operator", ham), ("bra", bra)):
        bad = [t for t in tn if not (t.data.is_cuda
                                     and t.dtype == torch.float64)]
        if bad:
            raise AssertionError(f"{name} tensor {bad[0]} is not float64 "
                                 f"on the card")
    print(f"networks: ket {ket.num_tensors} tensors, operator "
          f"{ham.num_tensors}, bra {bra.num_tensors}; all float64 on the "
          f"card", flush=True)
    if not native_available():
        raise AssertionError("the native path finder did not build/load")
    print("native path finder: loaded", flush=True)

    t0 = time.perf_counter()
    e_host, n_host = host_f64_sweep(As, Ws)
    print(f"host float64 sweep: <psi|H|psi> {e_host:.12f}, <psi|psi> "
          f"{n_host:.15f} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # <psi|psi> by quimb_tpu's default path, "auto" (native random-greedy):
    # the bra with its physical indices back on the ket's
    norm_tn = bra.reindex({f"q{i}": f"p{i}" for i in range(L)}) & ket
    info, search = _tn_search(norm_tn, "auto")
    n_auto, secs = _tn_timed(lambda: norm_tn.contract(all, optimize="auto"))
    n_auto = _tn_scalar(n_auto)
    _tn_report("<psi|psi> by 'auto'", info, search, secs)
    rel = abs(n_auto - n_host) / abs(n_host)
    print(f"<psi|psi> {n_auto:.15f}, relative to the host sweep "
          f"{rel:.3e} (bound {TN_NORM_TOL:.0e})", flush=True)
    if not rel < TN_NORM_TOL:
        raise AssertionError("<psi|psi> misses the host sweep")

    # <psi|H|psi> / <psi|psi> by the site-by-site sweep
    energy_tn = bra & ham & ket
    sites = [f"I{i}" for i in range(L)]
    e_cum, secs = _tn_timed(lambda: energy_tn.contract_cumulative(sites))
    e_cum = _tn_scalar(e_cum)
    print(f"<psi|H|psi> by contract_cumulative over I0..I{L - 1}: "
          f"{secs:.4f} s warm (median of 3)", flush=True)
    busy, top, wall_us, count = _busy_share(
        lambda: energy_tn.contract_cumulative(sites))
    print(f"contract_cumulative busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'} of "
          f"{wall_us / 1e3:.1f} ms, {count} device activities; top "
          f"{[(n[:40], round(us, 1)) for n, us in top]}", flush=True)
    flops, width = _tn_counted(lambda: energy_tn.contract_cumulative(sites))
    print(f"  {L} steps: flops {flops:.4e}, width {width:.2f}, "
          f"{flops / secs / 1e12:.3f} TFLOP/s", flush=True)
    _tn_check_energy("contract_cumulative", e_cum / n_auto, e_host / n_host)

    # "auto" on the energy network: searched, not run
    info, search = _tn_search(energy_tn, "auto", output_inds=())
    print(f"<psi|H|psi> by 'auto' (searched, not run): path search "
          f"{search:.3f} s, flops {info.flops:.4e}, width "
          f"{info.width:.2f}", flush=True)

    # the same ratio by quimb_tpu's greedy path, the heaviest contraction
    # the port runs
    info, search = _tn_search(energy_tn, "greedy", output_inds=())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    e_greedy, secs = _tn_timed(lambda: energy_tn.contract(
        all, output_inds=(), optimize="greedy"))
    e_greedy = _tn_scalar(e_greedy)
    peak = torch.cuda.max_memory_allocated()
    _tn_report("<psi|H|psi> by 'greedy'", info, search, secs)
    print(f"  its largest intermediate {2 ** info.width * 8 / 1e9:.2f} GB "
          f"(float64); torch.cuda.max_memory_allocated {peak / 1e9:.2f} GB "
          f"(allocated before {m0 / 1e9:.2f} GB)", flush=True)
    _tn_check_energy("greedy", e_greedy / n_auto, e_host / n_host)
    torch.cuda.empty_cache()

    _tn_compress_check(ket)
    n = {k: ck.LAUNCHES[k] - before[k] for k in before}
    if sum(n.values()):
        raise AssertionError(f"the tensor-network layer launched the "
                             f"sandwich kernels {n}")
    print(f"tensor-network phase: {time.perf_counter() - t_phase:.1f} s, "
          f"sandwich launches {n}", flush=True)


def _tn_check_energy(what, ratio, ref):
    rel = abs(ratio - ref) / abs(ref)
    rel_ref = abs(ratio - E_REF) / abs(E_REF)
    print(f"<psi|H|psi>/<psi|psi> by {what}: {ratio:.12f}, relative to the "
          f"host sweep {rel:.3e} (bound {TN_ENERGY_TOL:.0e}), to E_REF "
          f"{rel_ref:.3e} (bound {E_REL_TOL[torch.float64]:.0e})",
          flush=True)
    if not (rel < TN_ENERGY_TOL and rel_ref < E_REL_TOL[torch.float64]):
        raise AssertionError(f"the energy by {what} misses its bounds")


def _tn_compress_check(ket):
    """canonize_between and compress_between at bond 64 on a copy of the
    ket, through the port's array_split, against a direct rank-128
    truncation by torch.linalg.svd; and tensor_split of the fused pair."""
    a, b = f"I{TN_BOND - 1}", f"I{TN_BOND}"
    kc = ket.copy()
    norm0 = float(kc.make_norm().contract(all)) ** 0.5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kc.canonize_between(a, b)
    torch.cuda.synchronize()
    t_canon = time.perf_counter() - t0
    norm1 = float(kc.make_norm().contract(all)) ** 0.5
    pair = quimb_torch.tensor_contract(kc[a], kc[b])
    left = (f"k{TN_BOND - 1}", f"p{TN_BOND - 1}")
    right = (f"p{TN_BOND}", f"k{TN_BOND + 1}")
    theta = pair.transpose(*left, *right).data
    theta = theta.reshape(theta.shape[0] * theta.shape[1], -1)
    U, s, VH = torch.linalg.svd(theta, full_matrices=False)
    k = TN_MAX_BOND
    ref = (U[:, :k] * s[:k]) @ VH[:k]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kc.compress_between(a, b, max_bond=k, cutoff=0.0)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    bond = kc.bond_size(a, b)
    got = quimb_torch.tensor_contract(kc[a], kc[b]).transpose(
        *left, *right).data.reshape(ref.shape)
    err = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    tl, tr = pair.split(left, max_bond=k, cutoff=0.0, get="tensors")
    got_split = quimb_torch.tensor_contract(tl, tr).transpose(
        *left, *right).data.reshape(ref.shape)
    err_split = float(torch.linalg.norm(got_split - ref)
                      / torch.linalg.norm(ref))
    canon = abs(norm1 - norm0) / norm0
    print(f"bond {TN_BOND} (was {ket.bond_size(a, b)}): canonize_between "
          f"{t_canon * 1e3:.2f} ms, norm {norm0:.15f} -> {norm1:.15f} "
          f"(relative {canon:.3e}, bound {TN_CANON_TOL:.0e}); "
          f"compress_between to {bond} in {t_comp * 1e3:.2f} ms, product "
          f"against the rank-{k} SVD truncation {err:.3e}, tensor_split's "
          f"{err_split:.3e} (bound {TN_SPLIT_TOL:.0e}); s[{k - 1}] "
          f"{float(s[k - 1]):.3e}, s[{k}] {float(s[k]):.3e}", flush=True)
    if bond != k or tl.shape[-1] != k:
        raise AssertionError(f"the compressed bond is {bond}, not {k}")
    if not (err < TN_SPLIT_TOL and err_split < TN_SPLIT_TOL):
        raise AssertionError("the compressed pair misses the truncation")
    if not canon < TN_CANON_TOL:
        raise AssertionError("canonize_between changed the ket's norm")


# -- phase 10: the TEBD quench ------------------------------------------------

TEBD_L, TEBD_CHI, TEBD_STEPS, TEBD_DT, TEBD_CUTOFF = 64, 64, 20, 0.05, 1e-10
TEBD_REAL = {torch.complex128: torch.float64, torch.complex64: torch.float32}
# bounds on the largest distance of the 20 entropies from the reference
# curve: about 2.5 times quimb_tpu's own in complex128 (8.0e-5 on a CPU);
# complex64 with a truncation mask that keeps the weight above the cutoff
# read 7.8e-5 on an H100. And on |<psi|psi> - 1| of the final state: in
# complex64 that is the float32 rounding of 64 B-form tensors, which on a
# CPU wanders between 1e-6 and 2e-5 from step to step, with no drift
TEBD_ENT_TOL = {torch.complex128: 2e-4, torch.complex64: 2e-4}
TEBD_NORM_TOL = {torch.complex128: 1e-8, torch.complex64: 1e-4}
# quimb_tpu's own complex128 curve of this quench, from
# ``JAX_PLATFORMS=cpu QUIMB_TPU_X64=1 python benchref/measure_tpu_tebd.py
# 64 64 20 0.05`` on a CPU (printed against, not gated)
QUIMB_TPU_CPU_C128 = np.array([
    0.0075482694509380124, 0.025140156527633736, 0.04982170841521701,
    0.07992733626961111, 0.11423208603258764, 0.15175386766845503,
    0.1916759939046804, 0.23331062892568086, 0.27607940365553924,
    0.31950184589079034, 0.3631872774508482, 0.4068279870093512,
    0.4501926988774144, 0.49311952447586543, 0.5355083258439821,
    0.5773123813641874, 0.6185295808309791, 0.6591932696663401,
    0.6993631970176517, 0.7391166856784459,
])
# cuSOLVER's SVD drivers, timed on one parity sweep's batch, beside the
# quench's own route (decomp.safe_svd: the checked gesvdj in complex128),
# and the bound on ||U^H U - I||_2 and ||VH VH^H - I||_2 that the route
# must hold there: the Hastings update needs isometric factors
SVD_DRIVERS = ("gesvd", "gesvdj", None, "safe_svd")
SVD_ORTHO_TOL = {torch.complex128: 1e-12, torch.complex64: 1e-5}


def _tebd_reference():
    """jcmgray/quimb's complex128 run of the quench (entropies, err)."""
    ref = json.loads(Path("benchref/REFBASE.json").read_text())
    ref = ref["tebd_L64_chi64"]
    return np.asarray(ref["entropies"]), ref["err"]


def _device_kernels(fn):
    """The device time (us) of ``fn()``'s device activities by name, its
    wall time (us) and the count of device activities, from
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            count += 1
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    return by_name, wall_us, count


def _busy_share(fn):
    """Device time over wall time of ``fn()``, the kernels that took most
    of it and the count of device activities, from torch.profiler; None
    for the share where the profiler saw no device time."""
    by_name, wall_us, count = _device_kernels(fn)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (busy / wall_us if busy > 0 else None), top, wall_us, count


def _theta_batch(tebd):
    """The even bonds' theta = ls . B1 B2 of the state, (32, 128, 128)."""
    Bs, ls = tebd._vidal
    idx = tebd._pair_index(0)
    m, chi, d = idx.numel(), Bs.shape[1], Bs.shape[2]
    th = torch.einsum("mlpc,mcqr->mlpqr", Bs[idx], Bs[idx + 1])
    return (th * ls[idx][:, :, None, None, None]).reshape(m, chi * d, d * chi)


def svd_driver_table(theta):
    """Each SVD driver on the batch ``theta``: median wall ms of one call,
    and the largest ||U^H U - I||_2 and ||VH VH^H - I||_2 over the batch."""
    eye = torch.eye(theta.shape[-1], dtype=theta.dtype, device=theta.device)
    print(f"SVD drivers on {tuple(theta.shape)} {theta.dtype} (one parity "
          f"sweep's batch):", flush=True)
    rows = {}
    for driver in SVD_DRIVERS:
        if driver == "safe_svd":
            svd = functools.partial(decomp.safe_svd, theta)
            name = "the quench's route, decomp.safe_svd (checked gesvdj" + (
                ", via complex128)" if theta.dtype == torch.complex64
                else ")")
        else:
            svd = functools.partial(torch.linalg.svd, theta,
                                    full_matrices=False, driver=driver)
            name = driver or "default"
        try:
            U, _, VH = svd()
        except torch.linalg.LinAlgError as err:
            # a driver of cuSOLVER alone may fail; the route may not
            if driver == "safe_svd":
                raise
            print(f"  {name}: failed ({str(err).splitlines()[0]})",
                  flush=True)
            continue
        ms = _host_ms(svd)
        ortho_u = torch.linalg.matrix_norm(decomp.dag(U) @ U - eye, 2)
        ortho_v = torch.linalg.matrix_norm(VH @ decomp.dag(VH) - eye, 2)
        rows[driver] = (ms, ortho_u.max().item(), ortho_v.max().item())
        print(f"  {name}: {ms:.3f} ms, ||U^H U - I||_2 "
              f"{rows[driver][1]:.3e}, ||VH VH^H - I||_2 "
              f"{rows[driver][2]:.3e}", flush=True)
    return rows


def _host_norm(As):
    """<psi|psi> of a list state, in complex128 numpy."""
    env = np.ones((1, 1))
    for A in As:
        A = to_host(A).astype(np.complex128)
        env = np.einsum("ab,apx,bpy->xy", env, A, A.conj())
    return env.reshape(()).real


def run_tebd_path(dtype):
    """The quench in ``dtype`` through the entry points, with no device."""
    ref_ent, ref_err = _tebd_reference()
    psi0 = quimb_torch.MPS_neel_state(TEBD_L, dtype=TEBD_REAL[dtype])
    H = quimb_torch.ham_1d_heis(TEBD_L)
    opts = {"max_bond": TEBD_CHI, "cutoff": TEBD_CUTOFF}
    if not all(t.data.is_cuda for t in psi0):
        raise AssertionError("MPS_neel_state with no device is not on the GPU")

    warm = quimb_torch.TEBD(psi0, H, split_opts=opts, progbar=False)
    t0 = time.perf_counter()
    warm.update_to(2 * TEBD_DT, dt=TEBD_DT)
    torch.cuda.synchronize()
    print(f"TEBD {dtype} warm-up (2 steps on a copy): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    _reset_launches()
    redos = dict(decomp.SVD_REDOS)
    tebd = quimb_torch.TEBD(psi0, H, split_opts=opts, progbar=False)
    entropies, seconds = [], []
    for k in range(1, TEBD_STEPS + 1):
        t0 = time.perf_counter()
        tebd.update_to(k * TEBD_DT, dt=TEBD_DT)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        entropies.append(tebd.entropy(TEBD_L // 2))
        print(f"TEBD {dtype} step {k}: {seconds[-1]:.4f} s, S(L/2) "
              f"{entropies[-1]:.10f}", flush=True)
    launches = sum(ck.LAUNCHES.values())
    print(f"TEBD {dtype}: {statistics.mean(seconds):.4f} s per step (mean of "
          f"{TEBD_STEPS}; median {statistics.median(seconds):.4f}), "
          f"sandwich launches {dict(ck.LAUNCHES)}", flush=True)

    Bs, ls = tebd._vidal
    for name, t, want in (("Bs", Bs, dtype), ("ls", ls, TEBD_REAL[dtype])):
        finite = bool(torch.isfinite(t).all())
        if not (t.is_cuda and t.dtype == want and finite):
            raise AssertionError(f"TEBD stack {name}: {t.device} {t.dtype}, "
                                 f"or not finite")
    dist = np.abs(np.asarray(entropies) - ref_ent)
    print(f"TEBD {dtype} entropies against the reference curve: max "
          f"{dist.max():.3e} (bound {TEBD_ENT_TOL[dtype]:.0e}) at step "
          f"{int(dist.argmax()) + 1}", flush=True)
    own = np.abs(np.asarray(entropies) - QUIMB_TPU_CPU_C128).max()
    print(f"  against quimb_tpu's complex128 CPU curve: max {own:.3e}",
          flush=True)
    rel_err = abs(tebd.err - ref_err) / ref_err
    print(f"TEBD {dtype} err {tebd.err!r} against {ref_err!r}: relative "
          f"{rel_err:.3e}; discarded weight (trunc_err) {tebd.trunc_err!r}",
          flush=True)
    if not dist.max() <= TEBD_ENT_TOL[dtype]:
        raise AssertionError("TEBD entropies miss the reference curve")
    if not rel_err <= 1e-9:
        raise AssertionError("TEBD err misses the reference's")
    if launches:
        raise AssertionError("TEBD launched a sandwich kernel")

    print(f"TEBD {dtype}: SVD batches that gesvdj failed on and gesvd "
          f"redid in the {TEBD_STEPS} steps: "
          f"{decomp.SVD_REDOS[dtype] - redos[dtype]}",
          flush=True)
    theta = _theta_batch(tebd)
    rows = svd_driver_table(theta)
    if not max(rows["safe_svd"][1:]) <= SVD_ORTHO_TOL[dtype]:
        raise AssertionError("the SVD route of the quench lost "
                             "orthogonality")
    share, top, wall_us, count = _busy_share(
        lambda: warm.update_to(3 * TEBD_DT, dt=TEBD_DT))
    print(f"TEBD {dtype} step 3 of the copy under torch.profiler: "
          f"{wall_us / 1e3:.3f} ms wall, {count} device activities, busy "
          f"share " + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)

    pt = tebd.pt
    if not (isinstance(pt, quimb_torch.MatrixProductState)
            and all(t.data.is_cuda for t in pt)):
        raise AssertionError("TEBD.pt is not an MPS on the GPU")
    nrm = _host_norm(_arrays(pt))
    print(f"TEBD {dtype} final state: bonds "
          f"{max(pt.bond_sizes())}, |<psi|psi> - 1| "
          f"{abs(nrm - 1):.3e} (bound {TEBD_NORM_TOL[dtype]:.0e})", flush=True)
    if not abs(nrm - 1) <= TEBD_NORM_TOL[dtype]:
        raise AssertionError("the TEBD state lost its norm")


# -- phase 11: the exact 20-qubit core ----------------------------------------

EXACT_N, EXACT_T, EXACT_NT, EXACT_NCV = 20, 1.0, 4, 20
# float64 / complex128 end to end: quimb_tpu's own CPU run of the harness
# reaches REFBASE to 5e-15 (energy) and 7e-15 (<Z_0>)
EXACT_E_TOL, EXACT_Z_TOL, EXACT_NORM_TOL, EXACT_MV_TOL = (1e-10, 1e-9,
                                                          1e-10, 1e-12)


def _exact_reference():
    """jcmgray/quimb's run of the exact core (energy, <Z_0> at t = k/4)."""
    ref = json.loads(Path("benchref/REFBASE.json").read_text())["exact20"]
    return ref["groundenergy"], np.asarray(ref["z0_checkpoints"])


@contextlib.contextmanager
def _counted_matvecs():
    """Counts the LocalTermsHam matvecs made inside the block."""
    count = [0]
    matvec = core.LocalTermsHam.matvec

    def counted(self, x):
        count[0] += 1
        return matvec(self, x)

    core.LocalTermsHam.matvec = counted
    try:
        yield count
    finally:
        core.LocalTermsHam.matvec = matvec


def _timed(fn):
    """(result, seconds) of ``fn()`` on a synchronised host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _d2h_bytes(fn, attempts=3):
    """(fn(), the bytes torch.profiler saw copied from the card to the
    host during it): the trace's device-to-host copies, less a 1 MiB
    control copy made after ``fn()``. A session whose trace lacks the
    control copy is run again, ``fn()`` with it, and after ``attempts``
    such sessions the run fails: on the card the first session after the
    earlier phases' recorded no device activity at all, the next one
    every copy."""
    from torch.profiler import ProfilerActivity, profile

    control = torch.zeros(2**17, dtype=torch.float64, device="cuda")
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            control.cpu()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        copied = sum(int(e.get("args", {}).get("bytes", 0)) for e in events
                     if e.get("cat") == "gpu_memcpy"
                     and "DtoH" in e.get("name", ""))
        if copied >= 2**20:
            return out, copied - 2**20
    raise AssertionError(f"torch.profiler recorded no 1 MiB control copy "
                         f"in {attempts} sessions")


def _on_card(what, t, dtype):
    if not (t.is_cuda and t.dtype == dtype and bool(torch.isfinite(t).all())):
        raise AssertionError(f"{what}: {t.device} {t.dtype}, or not finite")


def exact_matvec_table(H):
    """The matvec of the LocalTermsHam and of the ELL SparseHam of ``H``
    on the card, in float64 and complex128: CUDA-event ms against the
    bound of reading x and writing H x once, and the agreement of the
    two, gated at EXACT_MV_TOL relative."""
    lt = quimb_torch.device_operator(H)
    ell, build_s = _timed(lambda: core.SparseHam(H))
    _on_card("LocalTermsHam terms", lt.mats[0], torch.float64)
    _on_card("SparseHam values", ell.vals, torch.float64)
    n = lt.shape[0]
    print(f"exact core operators: LocalTermsHam of {len(lt.sites)} terms; "
          f"ELL SparseHam ({n} x {ell.cols.shape[1]}, built on the host in "
          f"{build_s:.3f} s)", flush=True)
    rng = np.random.default_rng(SEED)
    for dtype in (torch.float64, torch.complex128):
        host = rng.standard_normal(n)
        if dtype.is_complex:
            host = host + 1j * rng.standard_normal(n)
        x = _cuda(host, dtype)
        want = lt.matvec(x)
        rel = (torch.linalg.norm(ell.matvec(x) - want)
               / torch.linalg.norm(want)).item()
        nbytes = 2 * n * dtype.itemsize
        bound_ms = nbytes / PEAK_BYTES * 1e3
        # the loop's own traffic: the zero fill, then per term one read of
        # x and a read and a write of the output
        loop_bytes = (1 + 3 * len(lt.sites)) * n * dtype.itemsize
        ms = {"LocalTermsHam": [], "SparseHam": []}
        for name in ("LocalTermsHam", "SparseHam", "SparseHam",
                     "LocalTermsHam"):
            op = lt if name == "LocalTermsHam" else ell
            ms[name].append(_event_ms(op.matvec, (x,), reps=20))
        print(f"exact matvec {dtype}: LocalTermsHam {ms['LocalTermsHam']} "
              f"ms, ELL SparseHam {ms['SparseHam']} ms; bound (2 x {n} x "
              f"{dtype.itemsize} B over {PEAK_BYTES / 1e12:.2f} TB/s) "
              f"{bound_ms:.4f} ms; the per-term loop moves "
              f"{loop_bytes / 1e9:.3f} "
              f"GB ({loop_bytes / PEAK_BYTES * 1e3:.4f} ms at that rate); "
              f"ELL against LocalTermsHam: relative {rel:.3e} (bound "
              f"{EXACT_MV_TOL:.0e})", flush=True)
        if not rel <= EXACT_MV_TOL:
            raise AssertionError("the ELL matvec disagrees with the "
                                 "LocalTermsHam one")
        if dtype.is_complex:
            terms = []
            for sites, m in zip(lt.sites, lt.mats):
                one = core.LocalTermsHam(lt.dims, {sites: to_host(m)})
                ms_one = _event_ms(one.matvec, (x,), reps=10)
                terms.append(f"{sites}: {ms_one:.4f}")
            print(f"  each term alone (zero fill + one product), ms: "
                  + ", ".join(terms), flush=True)
        del x, want
    del ell
    torch.cuda.empty_cache()


def run_exact_path():
    """The exact core through the entry points, with no device."""
    e_ref, z_ref = _exact_reference()
    H, build_s = _timed(lambda: quimb_torch.ham_heis(EXACT_N, sparse=True))
    print(f"exact core: ham_heis({EXACT_N}, sparse=True) on the host: "
          f"{build_s:.3f} s, {H.nnz} nonzeros", flush=True)
    exact_matvec_table(H)

    energies = []
    for label in ("cold", "warm"):
        with _counted_matvecs() as count:
            e, secs = _timed(lambda: quimb_torch.groundenergy(H))
        _on_card("groundenergy", e, torch.float64)
        energies.append(float(e))
        print(f"groundenergy ({label}): {energies[-1]!r} in {secs:.3f} s, "
              f"{count[0]} matvecs, {count[0] // EXACT_NCV} Lanczos restarts "
              f"of {EXACT_NCV}", flush=True)
    psi, secs = _timed(lambda: quimb_torch.groundstate(H))
    _on_card("groundstate", psi, torch.float64)
    op = quimb_torch.device_operator(H)
    _on_card("device_operator", op.mats[0], torch.float64)
    rayleigh = torch.vdot(psi[:, 0], op @ psi[:, 0]).item() / torch.vdot(
        psi[:, 0], psi[:, 0]).item()
    print(f"groundstate: {secs:.3f} s, its Rayleigh quotient {rayleigh!r}",
          flush=True)
    rel = max(abs(e - e_ref) for e in (*energies, rayleigh)) / abs(e_ref)
    print(f"exact core energy against REFBASE's {e_ref!r}: relative "
          f"{rel:.3e} (bound {EXACT_E_TOL:.0e})", flush=True)
    if not rel <= EXACT_E_TOL:
        raise AssertionError("the exact core's energy misses REFBASE's")
    share, top, wall_us, count = _busy_share(
        lambda: quimb_torch.groundenergy(H))
    print(f"groundenergy under torch.profiler: {wall_us / 1e3:.3f} ms wall, "
          f"{count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"), flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    del psi, op

    p0 = quimb_torch.computational_state("01" * (EXACT_N // 2))
    _on_card("computational_state", p0, torch.complex128)
    bit0 = (torch.arange(2**EXACT_N, device=p0.device) >> (EXACT_N - 1)) & 1
    zdiag = (1 - 2 * bit0).to(torch.float64)

    def z0(psi):
        p = torch.abs(psi.reshape(-1)) ** 2
        return (torch.sum(p * zdiag) / torch.sum(p)).item()

    warm = quimb_torch.Evolution(p0, H, method="expm")
    _, secs = _timed(lambda: warm.update_to(EXACT_T / EXACT_NT))
    print(f"Evolution warm-up (one update on a copy): {secs:.3f} s",
          flush=True)
    evo = quimb_torch.Evolution(p0, H, method="expm")
    zs, seconds = [], []
    for k in range(1, EXACT_NT + 1):
        with _counted_matvecs() as count:
            _, secs = _timed(lambda: evo.update_to(EXACT_T * k / EXACT_NT))
        seconds.append(secs)
        zs.append(z0(evo.pt))
        print(f"Evolution t={evo.t:.3f}: <Z_0> {zs[-1]!r}, {secs:.3f} s, "
              f"{count[0]} matvecs", flush=True)
    _on_card("Evolution state", evo.pt, torch.complex128)
    dist = np.abs(np.asarray(zs) - z_ref)
    nrm = torch.linalg.norm(evo.pt).item()
    print(f"Evolution: {statistics.mean(seconds):.3f} s per update (mean of "
          f"{EXACT_NT}); <Z_0> against REFBASE: max {dist.max():.3e} (bound "
          f"{EXACT_Z_TOL:.0e}); | |psi| - 1 | {abs(nrm - 1):.3e} (bound "
          f"{EXACT_NORM_TOL:.0e})", flush=True)
    if not dist.max() <= EXACT_Z_TOL:
        raise AssertionError("the exact core's <Z_0> misses REFBASE's")
    if not abs(nrm - 1) <= EXACT_NORM_TOL:
        raise AssertionError("the evolved state lost its norm")
    share, top, wall_us, count = _busy_share(
        lambda: warm.update_to(2 * EXACT_T / EXACT_NT))
    print(f"expm update under torch.profiler: {wall_us / 1e3:.3f} ms wall, "
          f"{count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"), flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    del warm, evo
    torch.cuda.empty_cache()
    return zs


# -- phase 13: the 53-qubit circuit -------------------------------------------

# (CIRC_SAMPLES: the draw of phase 15's CircuitMPS)
CIRC_N, CIRC_DEPTH, CIRC_SAMPLES, CIRC_SEED = 53, 12, 20, 42
# relative distance of each amplitude from jcmgray/quimb's (REFBASE): the
# port's complex128 run on a CPU reaches 3e-12 (float64 round-off over a
# 466-tensor contraction); complex64 reaches the order of quimb_tpu's TPU
# run (3e-5)
CIRC_AMP_TOL = {torch.complex128: 1e-9, torch.complex64: 1e-3}
# quimb_tpu's strings of ``Circuit.sample(5, seed=42)`` on this circuit,
# from ``JAX_PLATFORMS=cpu python scripts/circuit53_samples.py 5`` on a CPU
# (20 samples until the 3D and BP phases were added: a draw of 20 took
# 33-58 s on the card; 10 until phases 24-25 were added)
CIRC_DENSE_SAMPLES = 5
CIRC_REF_SAMPLES = (
    "10111111010000001000110010001110000101011111111110101",
    "01011100101111100010011100000110001011100101000011110",
    "11000011011000100000001100001111100010000011010010110",
    "10000001011100100111100010011101100110001101100101100",
    "01010100010011111110011110011101000110011100011001000",
)


def _circuit_qasm():
    """benchref/circuit53.py's OpenQASM 2 string (numpy only, loaded by
    its path: it is no part of the package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "circuit53", "benchref/circuit53.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.qasm_circuit(CIRC_N, CIRC_DEPTH)


def _circuit_reference():
    """REFBASE's amplitudes: amp0, then the four bitstrings of
    benchref/measure_tpu_circuit53.py (from np.random.default_rng(0))."""
    ref = json.loads(Path("benchref/REFBASE.json").read_text())["circuit53"]
    amps = {"0" * CIRC_N: complex(*ref["amp0"])}
    rng = np.random.default_rng(0)
    for _ in range(4):
        b = "".join(rng.choice(["0", "1"], size=CIRC_N))
        amps[b] = complex(*ref["amps"][b])
    return amps


@contextlib.contextmanager
def _pair_steps(circ):
    """Counts, inside the block, the pairwise contraction steps by the
    kind of their operands ("numpy" for the host rewrites), and the
    circuit's final contractions by the devices their operands lay on."""
    from quimb_torch.ops import contraction

    steps, finals = {}, {}
    pair = contraction._pair_contract
    final = circ._contract

    def counted(a, la, b, lb, lo):
        kind = a.device.type if isinstance(a, torch.Tensor) else "numpy"
        steps[kind] = steps.get(kind, 0) + 1
        return pair(a, la, b, lb, lo)

    def recorded(tn, *args, **kwargs):
        out = final(tn, *args, **kwargs)
        for t in tn.tensor_map.values():
            kind = (t.data.device.type if isinstance(t.data, torch.Tensor)
                    else "numpy")
            finals[kind] = finals.get(kind, 0) + 1
        return out

    contraction._pair_contract = counted
    circ._contract = recorded
    try:
        yield steps, finals
    finally:
        contraction._pair_contract = pair
        del circ._contract


def _circuit_amplitudes(circ, dtype, ref):
    """Each amplitude cold, then warm, gated against REFBASE; the warm
    call split into the host rewrite and the card's contraction."""
    from quimb_torch.ops.contraction import contract_backend

    worst = 0.0
    for b, want in ref.items():
        _, cold_s = _timed(lambda: circ.amplitude(b))
        with _pair_steps(circ) as (steps, finals):
            amp, warm_s = _timed(lambda: circ.amplitude(b))
        if set(finals) != {"cuda"}:
            raise AssertionError(f"amplitude's final operands lay on "
                                 f"{finals}, not only on the card")
        rehearsal, host_s = _timed(lambda: circ.amplitude(b, rehearse=True))
        tn, expr = rehearsal["tn"], rehearsal["tree"]
        tn.apply_to_arrays(lambda a: torch.as_tensor(a, device="cuda"))
        _, card_s = _timed(lambda: tn.contract(..., optimize="auto"))
        rel = abs(amp - want) / abs(want)
        worst = max(worst, rel)
        print(f"circuit {dtype} amplitude {b[:12]}...: {amp!r}, relative "
              f"to REFBASE {rel:.3e}; cold {cold_s:.3f} s, warm "
              f"{warm_s:.3f} s = host rewrite and path (rehearse=True) "
              f"{host_s:.3f} s + the rest; the contraction alone on the "
              f"card {card_s * 1e3:.2f} ms ({len(tn.tensor_map)} tensors, "
              f"{len(expr.steps)} steps, flops {expr.flops:.3e}, width "
              f"{expr.width:.1f}); pairwise steps by operand {steps}",
              flush=True)
    print(f"circuit {dtype}: largest relative distance from REFBASE "
          f"{worst:.3e} (bound {CIRC_AMP_TOL[dtype]:.0e})", flush=True)
    if not worst <= CIRC_AMP_TOL[dtype]:
        raise AssertionError(f"circuit {dtype} amplitudes miss REFBASE")
    b0 = "0" * CIRC_N
    host_amp, host_s = _timed(lambda: circ.amplitude(b0, backend="numpy"))
    rel = abs(host_amp - circ.amplitude(b0)) / abs(host_amp)
    tn = circ.amplitude(b0, rehearse=True)["tn"]
    with contract_backend("numpy"):
        _, host_c_s = _timed(lambda: tn.contract(..., optimize="auto"))
    print(f"circuit {dtype} amp0 by backend='numpy': {host_s:.3f} s, its "
          f"contraction alone on the host {host_c_s * 1e3:.2f} ms, relative "
          f"to the card's {rel:.3e}", flush=True)
    share, top, wall_us, count = _busy_share(lambda: circ.amplitude(b0))
    print(f"circuit {dtype} warm amp0 under torch.profiler: "
          f"{wall_us / 1e3:.1f} ms wall, {count} device activities, busy "
          "share " + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)


def _marginal_exprs(circ):
    """The circuit's cached marginal expressions, as their cache entries:
    (the batched ones, the single ones)."""
    cache = circ._region_expr_cache
    keys = [k for k in list(cache) if cache[k] != "fallback"]
    return ([cache[k] for k in keys if k[0] == "batch"],
            [cache[k] for k in keys if k[0] != "batch"])


def run_circuit_path():
    """The 53-qubit circuit through the entry points, with no device."""
    qasm = _circuit_qasm()
    ref = _circuit_reference()
    _reset_launches()
    for dtype in (torch.complex128, torch.complex64):
        circ, secs = _timed(lambda: quimb_torch.tensor.Circuit
                            .from_openqasm2_str(qasm, dtype=dtype))
        if circ.device.type != "cuda":
            raise AssertionError(f"Circuit with no device is on "
                                 f"{circ.device}, not the GPU")
        print(f"circuit {dtype}: built from OpenQASM in {secs:.3f} s, "
              f"{circ.num_gates} gates, {circ._psi.num_tensors} tensors "
              f"(host arrays)", flush=True)
        _circuit_amplitudes(circ, dtype, ref)
        if dtype == torch.complex128:
            main_circ = circ

    with _pair_steps(main_circ) as (steps, finals):
        samples, secs = _timed(lambda: tuple(main_circ.sample(
            CIRC_DENSE_SAMPLES, seed=CIRC_SEED)))
    batched, single = _marginal_exprs(main_circ)
    print(f"circuit sample({CIRC_DENSE_SAMPLES}, seed={CIRC_SEED}): "
          f"{secs:.3f} s; "
          f"{len(batched)} of {-(-CIRC_N // 10)} groups by a batched "
          "expression "
          + ", ".join(f"({e[0].flops:.3e} flops, width {e[0].width:.1f})"
                      for e in batched)
          + f"; {len(single)} single marginal expressions "
          + ", ".join(f"({e[0].flops:.3e} flops, width {e[0].width:.1f})"
                      for e in single)
          + "; the other groups by the per-sample route; pairwise steps by "
          f"operand {steps}; operands of the per-sample final contractions "
          f"by device {finals}", flush=True)
    # the busy share over a short draw from a fresh circuit: profiling the
    # whole draw (about a million device activities) takes minutes
    fresh = quimb_torch.tensor.Circuit.from_openqasm2_str(qasm)
    share, top, wall_us, count = _busy_share(
        lambda: list(fresh.sample(2, seed=CIRC_SEED)))
    print(f"circuit sample(2, seed={CIRC_SEED}) of a fresh circuit under "
          f"torch.profiler: {wall_us / 1e6:.3f} s, {count} device "
          "activities, busy share " + ("not measured" if share is None
                                       else f"{share:.4f}"), flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    for i, (got, want) in enumerate(zip(samples, CIRC_REF_SAMPLES)):
        print(f"  sample {i}: {got} {'==' if got == want else '!='} "
              f"quimb_tpu's", flush=True)
    if samples != CIRC_REF_SAMPLES:
        raise AssertionError("the circuit's samples differ from quimb_tpu's")
    where = {a.device.type for entry in (*batched, *single)
             for a in entry[1]}
    if not set(finals) <= {"cuda"} or not where <= {"cuda"}:
        raise AssertionError(f"sampling's final operands lay on {finals}, "
                             f"its cached expressions' on {where}")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError(f"the circuit launched sandwich kernels "
                             f"{dict(ck.LAUNCHES)}")


# -- phase 14: the north-star state under the MPS / MPO object API -----------

# bonds whose Schmidt values and entropies are held to a host SVD
NS_BONDS = (32, 64, 96)
# bounds, relative: <psi|psi> and <psi|H|psi>/<psi|psi> against the host
# sweep (float64 sums over 128 sites in other orders); the Schmidt values
# against a float64 host SVD of the same canonical tensor; <H^2> against
# the host's; each sample's probability against |amplitude|^2 / <psi|psi>
NS_NORM_TOL, NS_ENERGY_TOL, NS_SCHMIDT_TOL, NS_H2_TOL, NS_OMEGA_TOL = (
    1e-12, 1e-10, 1e-10, 1e-8, 1e-10)
NS_MAX_BOND, NS_SAMPLES, NS_SEED = 256, 20, 42
# the sites of the S^z correlation and of the magnetization; the sites of
# the compression's profiled window
NS_PAIR, NS_SITE, NS_WINDOW = (63, 64), 64, (60, 68)


def host_f64_local(psi, ops):
    """<psi|prod_i ops[i]|psi> / <psi|psi> of the MPS for single-site
    operators ``ops`` ({site: 2 x 2}), in float64 numpy on the host."""
    env = np.ones((1, 1))
    nrm = np.ones((1, 1))
    for i, A in enumerate(_arrays(psi)):
        A = to_host(A).astype(np.float64)
        OA = np.einsum("ud,kdx->kux", ops[i], A) if i in ops else A
        # env (bra, ket): the ket's site, then the bra's
        env = np.tensordot(np.tensordot(env, OA, axes=(1, 0)), A,
                           axes=((0, 1), (0, 1))).T
        nrm = np.tensordot(np.tensordot(nrm, A, axes=(1, 0)), A,
                           axes=((0, 1), (0, 1))).T
    return float(env.reshape(())) / float(nrm.reshape(()))


def host_f64_h2(psi, H):
    """<psi|H H|psi> of the MPS under the MPO, by a sweep whose environment
    carries both operator layers (b, w, v, k), in float64 numpy on the
    host."""
    env = np.ones((1, 1, 1, 1))
    for A, W in zip(_arrays(psi), _arrays(H)):
        A = to_host(A).astype(np.float64)
        W = to_host(W).astype(np.float64)
        env = np.tensordot(env, A, axes=(3, 0))            # b w v d x
        env = np.tensordot(env, W, axes=((2, 3), (0, 3)))  # b w x y e
        env = np.tensordot(env, W, axes=((1, 4), (0, 3)))  # b x y z u
        env = np.tensordot(env, A, axes=((0, 4), (0, 1)))  # x y z a
        env = env.transpose(3, 2, 1, 0)                    # a z y x
    return float(env.reshape(()))


def _rel_check(what, got, want, tol):
    rel = abs(got - want) / abs(want)
    print(f"  {what}: {got!r} against the host's {want!r}, relative "
          f"{rel:.3e} (bound {tol:.0e})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{what} misses the host value")


def _busy_window(H, psi):
    """The device's busy share over H.apply + the variance, and over a
    window of the compression: the QRs of sites 60-67 in its
    left-canonizing sweep and the truncations of bonds 67-60 in its
    compressing sweep, the other steps run outside the profile. (A
    profile of the whole compression holds about 1.5 million device
    activities and takes minutes to process.)"""
    from quimb_torch.tensor.tn1d.core import expec_TN_1D

    def apply_and_variance():
        Hp = H.apply(psi)
        float(expec_TN_1D(Hp.H, Hp))

    shares = {"H.apply + variance": _busy_share(apply_and_variance)}
    Hp = H.apply(psi)
    a, b = NS_WINDOW

    def canonize(start, stop):
        for i in range(start, stop):
            Hp.left_canonize_site(i)

    def truncate(start, stop):
        for i in range(start, stop, -1):
            quimb_torch.tensor_compress_bond(
                Hp[Hp.site_tag(i - 1)], Hp[Hp.site_tag(i)], absorb="left",
                max_bond=NS_MAX_BOND, cutoff=0.0)

    # compress(form="right") step by step: left_canonize, then truncate
    # from the right end
    canonize(0, a)
    shares[f"compression: QRs of sites {a}-{b - 1}"] = _busy_share(
        lambda: canonize(a, b))
    canonize(b, L - 1)
    truncate(L - 1, b)
    shares[f"compression: truncations of bonds {b}-{a + 1}"] = _busy_share(
        lambda: truncate(b, a))
    truncate(a, 0)
    torch.cuda.synchronize()
    if max(Hp.bond_sizes()) != NS_MAX_BOND:
        raise AssertionError("the step-by-step compression's bonds")
    busy = wall = 0.0
    for what, (share, top, wall_us, count) in shares.items():
        print(f"{what} under torch.profiler: {wall_us / 1e3:.1f} ms wall, "
              f"{count} device activities, busy share "
              + ("not measured" if share is None else f"{share:.4f}"),
              flush=True)
        for name, us in top:
            print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
        busy += (share or 0.0) * wall_us
        wall += wall_us
    print("busy share over the three windows: "
          + (f"{busy / wall:.4f}" if busy > 0 else "not measured"),
          flush=True)


def run_mps_layer(dmrg):
    """The MPS / MPO object layer on the float64 DMRG2 state, L=128,
    chi=256: norms, expectations, Schmidt values, H|psi> at bond 1280, its
    compression back to 256, and samples."""
    from quimb_torch.tensor.tn1d.core import align_TN_1D, expec_TN_1D

    t_phase = time.perf_counter()
    _reset_launches()
    psi = dmrg.state
    H = quimb_torch.MPO_ham_heis(L, dtype=torch.float64, device="cuda")
    if not (isinstance(psi, quimb_torch.MatrixProductState)
            and isinstance(H, quimb_torch.MatrixProductOperator)
            and all(t.data.is_cuda and t.dtype == torch.float64
                    for t in (*psi, *H))):
        raise AssertionError("the state and the MPO are not float64 objects "
                             "on the card")
    e_host, n_host = host_f64_sweep(psi, H)
    E = e_host / n_host
    print(f"MPS layer: state bonds up to {max(psi.bond_sizes())}; host sweep "
          f"<psi|psi> {n_host!r}, E {E!r}", flush=True)

    nrm, secs = _timed(lambda: float(expec_TN_1D(psi.H, psi)))
    print(f"<psi|psi> by expec_TN_1D: {secs:.3f} s", flush=True)
    _rel_check("<psi|psi>", nrm, n_host, NS_NORM_TOL)
    sandwich = align_TN_1D(psi.H, H, psi)
    e, secs = _timed(lambda: float(expec_TN_1D(*sandwich)))
    print(f"<psi|H|psi> by expec_TN_1D of the aligned (bra, H, ket): "
          f"{secs:.3f} s", flush=True)
    _rel_check("<psi|H|psi>/<psi|psi>", e / nrm, E, NS_ENERGY_TOL)

    for i in NS_BONDS:
        c = psi.copy()
        (s2, ent), secs = _timed(lambda: (c.schmidt_values(i), c.entropy(i)))
        t = c[c.site_tag(i)]
        lb = c.bond(i - 1, i)
        mat = to_host(t.transpose(lb, *(ix for ix in t.inds if ix != lb))
                      .data).reshape(t.ind_size(lb), -1)
        ref = np.linalg.svd(mat, compute_uv=False) ** 2
        s2 = to_host(s2)
        rel = np.abs(s2 - ref).max() / ref.max()
        p = ref[ref > 1e-16]
        ent_ref = float(-np.sum(p * np.log2(p)))
        print(f"bond {i}: schmidt_values + entropy {secs:.3f} s (two "
              f"canonizing sweeps of {L - 1} QRs), {s2.size} values, largest "
              f"distance from the host SVD's {rel:.3e} (bound "
              f"{NS_SCHMIDT_TOL:.0e}); entropy {ent!r}, host {ent_ref!r}",
              flush=True)
        if not (rel <= NS_SCHMIDT_TOL
                and abs(ent - ent_ref) <= NS_SCHMIDT_TOL * ent_ref):
            raise AssertionError(f"Schmidt values at bond {i} miss the host")

    Sz = np.diag([0.5, -0.5])
    i, j = NS_PAIR
    corr, secs = _timed(lambda: float(psi.correlation(
        torch.tensor(Sz, dtype=torch.float64, device="cuda"), i, j)))
    print(f"correlation(Sz, {i}, {j}): {secs:.3f} s", flush=True)
    _rel_check(f"<Sz_{i} Sz_{j}>", corr, host_f64_local(psi, {i: Sz, j: Sz}),
               NS_ENERGY_TOL)
    mag, secs = _timed(lambda: float(psi.magnetization(NS_SITE)))
    want = host_f64_local(psi, {NS_SITE: 2 * Sz})
    print(f"magnetization({NS_SITE}): {mag!r} ({secs:.3f} s), host "
          f"{want!r}", flush=True)
    if not abs(mag - want) <= 1e-10:
        raise AssertionError("magnetization misses the host value")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    steps = {}
    Hpsi, steps["H.apply"] = _timed(lambda: H.apply(psi))
    h2, steps["<Hpsi|Hpsi>"] = _timed(
        lambda: float(expec_TN_1D(Hpsi.H, Hpsi)))
    Hc, steps["compress"] = _timed(
        lambda: Hpsi.copy().compress(max_bond=NS_MAX_BOND, cutoff=0.0))
    peak = torch.cuda.max_memory_allocated()
    overlap, steps["<psi|Hpsi_c>"] = _timed(
        lambda: float(expec_TN_1D(psi.H, Hc)))
    cross, steps["<Hpsi|Hpsi_c>"] = _timed(
        lambda: float(expec_TN_1D(Hpsi.H, Hc)))
    hc2, steps["<Hpsi_c|Hpsi_c>"] = _timed(
        lambda: float(expec_TN_1D(Hc.H, Hc)))
    for name, secs in steps.items():
        print(f"  {name}: {secs:.3f} s", flush=True)
    print(f"H.apply: bonds up to {max(Hpsi.bond_sizes())}; compressed to "
          f"{max(Hc.bond_sizes())}; peak allocation "
          f"{peak / 1e9:.3f} GB (allocated before {m0 / 1e9:.3f} GB)",
          flush=True)
    if max(Hpsi.bond_sizes()) != 5 * CHI or max(Hc.bond_sizes()) != \
            NS_MAX_BOND:
        raise AssertionError("the bonds of H|psi> or of its compression")
    t0 = time.perf_counter()
    h2_host = host_f64_h2(psi, H) / n_host
    var = h2 / nrm - (e / nrm) ** 2
    print(f"<H^2> {h2 / nrm!r} (host {h2_host!r}, "
          f"{time.perf_counter() - t0:.1f} s); variance <H^2> - E^2 "
          f"{var!r}", flush=True)
    _rel_check("<H^2>", h2 / nrm, h2_host, NS_H2_TOL)
    if not var >= -NS_H2_TOL * abs(h2_host):
        raise AssertionError("the variance is negative")
    # |<psi|H psi> - <psi|H psi_c>| <= |psi| |H psi - H psi_c|
    dist = max(h2 + hc2 - 2 * cross, 0.0) ** 0.5
    gap = abs(overlap - e)
    print(f"<psi|H psi_c>/<psi|psi> {overlap / nrm!r} against E {E!r}: "
          f"|<psi|H psi> - <psi|H psi_c>| {gap:.3e}, bound |psi| "
          f"|H psi - H psi_c| = {nrm ** 0.5 * dist:.3e}", flush=True)
    if not gap <= nrm ** 0.5 * dist * (1 + 1e-6) + 1e-10 * abs(e):
        raise AssertionError("the compressed H|psi> misses E beyond its "
                             "truncation")

    _busy_window(H, psi)
    del Hpsi, Hc
    torch.cuda.empty_cache()

    samples, secs = _timed(lambda: list(psi.sample(NS_SAMPLES,
                                                   seed=NS_SEED)))
    worst = 0.0
    for config, omega in samples:
        amp = float(psi.amplitude(config))
        worst = max(worst, abs(omega - amp**2 / nrm) / omega)
    print(f"sample({NS_SAMPLES}, seed={NS_SEED}): {secs:.3f} s "
          f"({NS_SAMPLES * L} host reads); largest relative distance of "
          f"omega from |amplitude|^2 / <psi|psi> {worst:.3e} (bound "
          f"{NS_OMEGA_TOL:.0e}); first {''.join(map(str, samples[0][0]))}",
          flush=True)
    if not worst <= NS_OMEGA_TOL:
        raise AssertionError("a sample's probability misses its amplitude")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError(f"the MPS layer launched sandwich kernels "
                             f"{dict(ck.LAUNCHES)}")
    print(f"MPS layer phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 15: CircuitMPS on the 53-qubit circuit -----------------------------

# relative distance of each amplitude from jcmgray/quimb's (REFBASE): the
# cutoff of 1e-10 truncates; quimb_tpu's CircuitMPS in complex128 reaches
# 7.4e-7 to 2.8e-6. And from quimb_tpu's own CircuitMPS amplitudes in
# complex128 (the same truncations in another SVD library)
CMPS_AMP_TOL = {torch.complex128: 1e-5, torch.complex64: 1e-3}
CMPS_QTPU_TOL = 1e-7
# quimb_tpu's CircuitMPS of this circuit (complex128, max_bond None, cutoff
# 1e-10), from ``JAX_PLATFORMS=cpu python scripts/circuit53_mps_samples.py``
# on a CPU: the bond sizes, the five amplitudes and sample(20, seed=42)
CMPS_QTPU_BONDS = (
    2, 4, 8, 16, 32, 64, 63, 64, 48, 64, 64, 64, 64, 64, 62, 64, 44, 64, 64,
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 58,
    64, 51, 64, 43, 64, 64, 64, 64, 64, 64, 32, 16, 8, 4, 2)
CMPS_QTPU_AMPS = {
    "00000000000000000000000000000000000000000000000000000":
        -6.642596423259146e-10 + 2.2014072995913224e-09j,
    "11100000011111111111011001101110010100000000011101100":
        5.249241920633562e-10 - 1.3687899627047772e-09j,
    "11101111110101111000011011011001110100100110001010011":
        -1.7683882267324828e-10 - 4.937894419184729e-10j,
    "00101010111010101010111011101100101111000100001101110":
        -4.499185038862496e-09 - 2.2823562511805886e-09j,
    "01100010100011111000111111001011100110101000011011001":
        1.2496932058819877e-09 + 1.3041551857880446e-09j,
}
CMPS_QTPU_SAMPLES = (
    "11110111010100101011101110100111000001010110100100001",
    "01111001101101001001000011110100010010000011001110111",
    "00010000011111110000000001000010100011100100110001000",
    "10100101101010100111111101000101001001100111100010111",
    "01110010011101001000111111001100011000110001100001101",
    "00000000110001100000000001010111111101110010010000111",
    "01110011110010110101010111111010100001101010001011010",
    "00000100101100111011001001010011011110111010001010000",
    "01010111110001111010011101011000111100101111010000000",
    "01010100110100111110100111001111001001001011000001110",
    "01010010011111001010000100001100110110000111111110110",
    "01000001000001111111111101011110110001010111001110100",
    "01111100110100011010101111000111000111101000000110110",
    "00100111110000101110011111000110001000001000100001100",
    "10110011010110010010001000010111011011011110101000100",
    "00011101100100100110111000100100011110011111101100111",
    "01001100110100110111001011110010001100000101001100000",
    "00110100011111100010100000111000110101001001011101000",
    "11110011001010100001000010111001000111101010100100111",
    "01010110011001111101011011111000000110001101010011011",
)


def run_circuit_mps_path():
    """The 53-qubit circuit as a CircuitMPS on the card, in complex128 and
    complex64."""
    t_phase = time.perf_counter()
    qasm = _circuit_qasm()
    ref = _circuit_reference()
    if set(ref) != set(CMPS_QTPU_AMPS):
        raise AssertionError("REFBASE's bitstrings are not quimb_tpu's")
    _reset_launches()
    for dtype in (torch.complex128, torch.complex64):
        circ, secs = _timed(lambda: quimb_torch.CircuitMPS
                            .from_openqasm2_str(qasm, dtype=dtype,
                                                device="cuda"))
        psi = circ.psi
        bonds = tuple(psi.bond_sizes())
        if not (circ.device.type == "cuda" and all(
                t.data.is_cuda and t.dtype == dtype for t in psi)):
            raise AssertionError("the CircuitMPS state is not on the card")
        print(f"CircuitMPS {dtype}: {circ.num_gates} gates applied in "
              f"{secs:.3f} s; bonds up to {max(bonds)}, "
              f"{'equal to' if bonds == CMPS_QTPU_BONDS else 'unlike'} "
              f"quimb_tpu's {bonds}", flush=True)
        if dtype == torch.complex128 and bonds != CMPS_QTPU_BONDS:
            raise AssertionError("the bond sizes differ from quimb_tpu's")
        worst = worst_q = 0.0
        for b, want in ref.items():
            amp, secs = _timed(lambda: circ.amplitude(b))
            rel = abs(amp - want) / abs(want)
            rel_q = abs(amp - CMPS_QTPU_AMPS[b]) / abs(CMPS_QTPU_AMPS[b])
            worst, worst_q = max(worst, rel), max(worst_q, rel_q)
            print(f"  amplitude {b[:12]}...: {amp!r} ({secs:.3f} s), "
                  f"relative to REFBASE {rel:.3e}, to quimb_tpu's "
                  f"CircuitMPS {rel_q:.3e}", flush=True)
        print(f"CircuitMPS {dtype}: largest relative distance from REFBASE "
              f"{worst:.3e} (bound {CMPS_AMP_TOL[dtype]:.0e}), from "
              f"quimb_tpu's {worst_q:.3e}" + (
                  f" (bound {CMPS_QTPU_TOL:.0e})"
                  if dtype == torch.complex128 else ""), flush=True)
        if not worst <= CMPS_AMP_TOL[dtype]:
            raise AssertionError(f"CircuitMPS {dtype} misses REFBASE")
        if dtype == torch.complex128 and not worst_q <= CMPS_QTPU_TOL:
            raise AssertionError("CircuitMPS misses quimb_tpu's amplitudes")
        fid, secs = _timed(circ.fidelity_estimate)
        print(f"CircuitMPS {dtype}: fidelity_estimate {fid!r} ({secs:.3f} "
              "s)", flush=True)
        if dtype == torch.complex128:
            samples, secs = _timed(lambda: tuple(circ.sample(
                CIRC_SAMPLES, seed=CIRC_SEED)))
            same = samples == CMPS_QTPU_SAMPLES
            print(f"CircuitMPS sample({CIRC_SAMPLES}, seed={CIRC_SEED}): "
                  f"{secs:.3f} s ({CIRC_SAMPLES * CIRC_N} host reads), "
                  f"{'equal to' if same else 'unlike'} quimb_tpu's", flush=True)
            for i, (got, want) in enumerate(zip(samples, CMPS_QTPU_SAMPLES)):
                if got != want:
                    print(f"  sample {i}: {got} != {want}", flush=True)
            if not same:
                raise AssertionError("CircuitMPS samples differ from "
                                     "quimb_tpu's")
        share, top, wall_us, count = _busy_share(
            lambda: quimb_torch.CircuitMPS.from_openqasm2_str(
                qasm, dtype=dtype, device="cuda"))
        print(f"CircuitMPS {dtype} gate application under torch.profiler: "
              f"{wall_us / 1e6:.3f} s wall, {count} device activities, busy "
              "share " + ("not measured" if share is None
                          else f"{share:.4f}"), flush=True)
        for name, us in top:
            print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    if sum(ck.LAUNCHES.values()):
        raise AssertionError(f"CircuitMPS launched sandwich kernels "
                             f"{dict(ck.LAUNCHES)}")
    print(f"CircuitMPS phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 16: the 16x16 PEPS -------------------------------------------------

PEPS_L, PEPS_D, PEPS_CHI, PEPS_NITS, PEPS_SEED = 16, 3, 32, 30, 42
PEPS_TAUS = (0.3, 0.1, 0.03)
# quimb_tpu's float64 values of the same protocol from the same arrays, on
# a CPU: JAX_PLATFORMS=cpu python scripts/peps16_reference.py, which also
# writes every gauge vector to PEPS_REF
PEPS_REF = "scripts/peps16_reference.json"
PEPS_QTPU_E_SITE = -0.6281269957057047
PEPS_QTPU_E_SIMPLE = -155.9586345760443
PEPS_QTPU_GAUGE_SUM = 565.0163438354033
PEPS_E_TOL, PEPS_GAUGE_TOL, PEPS_SIMPLE_TOL = 1e-6, 1e-6, 1e-8
PEPS_F32_SIMPLE_TOL = 1e-4
# the boundary steps of the energy's profiled window (three steps gave
# 190,000 device activities, which took the profiler about 20 s)
PEPS_WINDOW = 1
# printed beside the result, not gated: two artifacts that never ran one
# protocol with quimb_tpu (VERDICT.md:130-138)
PEPS_ARTIFACTS = (
    ("jcmgray/quimb on a CPU, benchref/ref_peps16.json", -0.6228427),
    ("quimb_tpu float32 on a CPU, benchref/crosscheck_peps16.log",
     -0.6302621),
)
CPEPS_L, CPEPS_DEPTH, CPEPS_SEED, CPEPS_BOND, CPEPS_TOL = 4, 4, 7, 64, 1e-10
# drops only numerically zero weight (the rsum2 tail of squared singular
# values below 1e-14 of the total): the gates' splits and the amplitudes'
# boundary stay exact, where cutoff 0 would keep the zeros up to the bond
# limit
CPEPS_CUTOFF = 1e-14


def peps_start_arrays(L, D, seed=PEPS_SEED, phys_dim=2):
    """``PEPS_rand``'s shapes (u, r, d, l, p, edge bonds dropped), drawn
    site by site from ``default_rng(seed)``: the arrays of
    scripts/peps16_reference.py."""
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(
        [D] * sum((i < L - 1, j < L - 1, i > 0, j > 0)) + [phys_dim])
        for j in range(L)] for i in range(L)]


def _peps_reference():
    """quimb_tpu's gauges by bond pair, checked against the constants."""
    ref = json.loads(Path(PEPS_REF).read_text())
    if (ref["L"], ref["D"], ref["chi"], ref["steps"]) != (
            PEPS_L, PEPS_D, PEPS_CHI, 2 + len(PEPS_TAUS) * PEPS_NITS) or (
            ref["energy_per_site"], ref["energy_simple"],
            ref["gauge_sum"]) != (PEPS_QTPU_E_SITE, PEPS_QTPU_E_SIMPLE,
                                  PEPS_QTPU_GAUGE_SUM):
        raise AssertionError(f"{PEPS_REF} is not the recorded reference")
    gauges = {}
    for key, v in ref["gauges"].items():
        a, b = (tuple(int(x) for x in c.split(",")) for c in key.split("-"))
        gauges[a, b] = np.asarray(v)
    return gauges


def _peps_evolve(dtype, ham):
    """SimpleUpdate of the start arrays in ``dtype``: evolve(2, tau=0.3),
    then PEPS_NITS steps at each tau, timed. Returns the updater and the
    seconds a step, with the host syncs each step made."""
    psi0 = quimb_torch.PEPS([[a.astype(numpy_dtype(dtype)) for a in row]
                             for row in peps_start_arrays(PEPS_L, PEPS_D)])
    su = quimb_torch.SimpleUpdate(psi0, ham, D=PEPS_D,
                                  compute_energy_every=None,
                                  compute_energy_final=False)
    _, warm = _timed(lambda: su.evolve(2, tau=0.3))
    if su._fstacks is None or not su._fstacks[0].is_cuda:
        raise AssertionError("SimpleUpdate did not run the fused stacks on "
                             "the card")
    secs = 0.0
    with _counted_syncs() as syncs:
        for tau in PEPS_TAUS:
            _, t = _timed(lambda: su.evolve(PEPS_NITS, tau=tau))
            secs += t
    nsteps = len(PEPS_TAUS) * PEPS_NITS
    print(f"SimpleUpdate {dtype}: {PEPS_L}x{PEPS_L}, D={PEPS_D}, warm-up "
          f"evolve(2) {warm:.3f} s, then {nsteps} steps at {secs / nsteps:.5f}"
          f" s a step ({secs:.3f} s); {len(syncs) / nsteps:.2f} host syncs a "
          f"step" + (f" ({sorted(set(syncs))})" if syncs else ""), flush=True)
    return su, secs / nsteps


def _peps_gauge_check(su, ref):
    """The largest distance of the port's gauge vectors from quimb_tpu's."""
    gauges = su.gauges
    if set(gauges) != set(ref) or len(ref) != 2 * PEPS_L * (PEPS_L - 1):
        raise AssertionError("the gauges' bonds differ from quimb_tpu's")
    got = torch.stack([gauges[k] for k in ref]).to(torch.float64)
    want = torch.as_tensor(np.stack(list(ref.values())), device=got.device)
    return float((got - want).abs().max()), float(got.sum())


def _class_batch(su):
    """One class update (horizontal, even) on a copy of the fused stacks,
    with the arrays its QRs and its bond SVD took, and the update's
    arguments."""
    F = su_fused
    S, GH, GV = (x.clone() for x in su._fstacks)
    p = S.shape[2]
    gates = F.class_gate_stacks(su.ham, PEPS_L, PEPS_L, -su.tau, p,
                                numpy_dtype(S.dtype), S.device)
    seen = {"qr": [], "svd": [], "qr_s": 0.0, "svd_s": 0.0}
    qr, svd = torch.linalg.qr, F._bond_svd

    def recorded(key, fn):
        def call(x, *a, **k):
            seen[key].append(x)
            out, secs = _timed(lambda: fn(x, *a, **k))
            seen[key + "_s"] += secs
            return out
        return call

    torch.linalg.qr = recorded("qr", qr)
    F._bond_svd = recorded("svd", svd)
    try:
        _, total = _timed(lambda: F._h_class_update(
            S, GH, GV, gates[0], 0, su.gauge_smudge))
    finally:
        torch.linalg.qr, F._bond_svd = qr, svd
    return seen, total


def peps_split_table(su):
    """One class's batch of bond SVDs by each route, with the QRs and the
    rest of the class update: median ms on a synchronised host clock, and
    each route's largest distance from a float64 host SVD's values."""
    F = su_fused
    # twice: the first call pays for the solvers' first use
    _class_batch(su)
    seen, total = _class_batch(su)
    qrs, M = seen["qr"], seen["svd"][0]
    D = PEPS_D
    s_ref = torch.as_tensor(np.linalg.svd(to_host(M).astype(np.float64),
                                          compute_uv=False)[..., :D])
    eye = torch.eye(D, dtype=M.dtype, device=M.device)
    routes = {
        "the path's route, su_fused._bond_svd (batched gesvdj)":
            lambda: F._bond_svd(M),
        "gesvd (one matrix at a time)":
            lambda: torch.linalg.svd(M, full_matrices=False,
                                     driver="gesvd"),
        "su_fused._topd_split (matmuls only)":
            lambda: F._topd_split(M, D),
    }
    print(f"bond split of one class ({tuple(M.shape)} {M.dtype}):",
          flush=True)
    rows = {}
    for name, fn in routes.items():
        u, s, v = fn()
        ms = _host_ms(fn)
        u, s, v = u[..., :, :D], s[..., :D], v[..., :D, :]
        ortho = float(torch.linalg.matrix_norm(
            u.mT.conj() @ u - eye, 2).max())
        err = float((s.double().cpu() - s_ref).abs().max()
                    / s_ref[..., 0].min())
        rows[name] = ms
        print(f"  {name}: {ms:.3f} ms, top-{D} values {err:.3e} relative "
              f"from a host SVD, ||U^T U - I||_2 {ortho:.3e}", flush=True)
    qr_ms, svd_ms = 1e3 * seen["qr_s"], 1e3 * seen["svd_s"]
    print(f"  one class update, each solver call synchronised: "
          f"{1e3 * total:.3f} ms; its {len(qrs)} QRs of {tuple(qrs[0].shape)}"
          f" {qr_ms:.3f} ms, its split {svd_ms:.3f} ms, the rest "
          f"{1e3 * total - qr_ms - svd_ms:.3f} ms; host syncs of one QR "
          f"{_syncs(lambda: torch.linalg.qr(qrs[0]))}, of one split "
          f"{_syncs(lambda: F._bond_svd(M))}", flush=True)
    return rows


@contextlib.contextmanager
def _counted_syncs():
    """Yields a list that holds, on exit, the messages of the synchronising
    CUDA operations made inside, as torch's sync debug mode reports them."""
    import warnings

    syncs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield syncs
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs += [str(w.message).splitlines()[0] for w in caught
              if "synchroniz" in str(w.message)]


def _syncs(fn):
    with _counted_syncs() as syncs:
        fn()
    return len(syncs)


def run_circuit_peps():
    """A 4x4 random circuit as a CircuitPEPS with a bond limit that keeps
    it exact, against the port's exact Circuit, both on the card."""
    gates, rng = circuit_peps_gates()
    n = CPEPS_L * CPEPS_L
    cp = quimb_torch.CircuitPEPS(CPEPS_L, max_bond=CPEPS_BOND,
                                 cutoff=CPEPS_CUTOFF)
    _, secs = _timed(lambda: cp.apply_gates(gates))
    exact = quimb_torch.Circuit(N=n)
    exact.apply_gates(gates)
    if not all(t.data.is_cuda and t.dtype == torch.complex128
               for t in cp.psi):
        raise AssertionError("the CircuitPEPS state is not on the card")
    worst = 0.0
    for b in ["0" * n] + ["".join(rng.choice(["0", "1"], size=n))
                          for _ in range(4)]:
        amp, t = _timed(lambda: cp.amplitude(b, cutoff=CPEPS_CUTOFF))
        want = complex(exact.amplitude(b))
        worst = max(worst, abs(amp - want))
        print(f"  CircuitPEPS amplitude {b}: {amp:.12e} ({t:.3f} s), "
              f"exact Circuit {want:.12e}", flush=True)
    print(f"CircuitPEPS {CPEPS_L}x{CPEPS_L}, depth {CPEPS_DEPTH}: "
          f"{len(gates)} gates in {secs:.3f} s, bonds up to "
          f"{cp.psi.max_bond()}; largest distance from the exact Circuit "
          f"{worst:.3e} (bound {CPEPS_TOL:.0e})", flush=True)
    if not worst <= CPEPS_TOL:
        raise AssertionError("CircuitPEPS misses the exact amplitudes")


def run_peps_path():
    """The 16x16 PEPS: SimpleUpdate and the chi=32 energy in float64, held
    to quimb_tpu's; SimpleUpdate in float32; CircuitPEPS. Returns the
    float64 state."""
    t_phase = time.perf_counter()
    ref = _peps_reference()
    _reset_launches()
    ham = quimb_torch.ham_2d_heis(PEPS_L, PEPS_L)
    su, _ = _peps_evolve(torch.float64, ham)
    # the class batches come from the fused stacks, before reading the
    # gauges turns them back into a PEPS
    peps_split_table(su)
    gerr, gsum = _peps_gauge_check(su, ref)
    print(f"SimpleUpdate float64: {len(ref)} gauge vectors, largest distance "
          f"from quimb_tpu's {gerr:.3e} (bound {PEPS_GAUGE_TOL:.0e}); sum "
          f"{gsum!r} (quimb_tpu's {PEPS_QTPU_GAUGE_SUM!r})", flush=True)
    if not gerr <= PEPS_GAUGE_TOL:
        raise AssertionError("the gauges miss quimb_tpu's")
    e_simple, secs = _timed(su.compute_energy_simple)
    rel = abs(e_simple - PEPS_QTPU_E_SIMPLE) / abs(PEPS_QTPU_E_SIMPLE)
    print(f"compute_energy_simple float64: {e_simple!r} ({secs:.3f} s), "
          f"relative to quimb_tpu's {rel:.3e} (bound {PEPS_SIMPLE_TOL:.0e})",
          flush=True)
    if not rel <= PEPS_SIMPLE_TOL:
        raise AssertionError("compute_energy_simple misses quimb_tpu's")
    psi, secs = _timed(su.get_state)
    print(f"get_state: {secs:.3f} s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    e, secs = _timed(lambda: psi.compute_local_expectation(
        ham.terms, max_bond=PEPS_CHI, normalized=True))
    peak = torch.cuda.max_memory_allocated() - base
    e_site = float(np.real(complex(e))) / PEPS_L ** 2
    diff = abs(e_site - PEPS_QTPU_E_SITE)
    print(f"compute_local_expectation(max_bond={PEPS_CHI}) float64: "
          f"{secs:.3f} s, peak allocation {peak / 1e9:.4f} GB; E/site "
          f"{e_site!r}, {diff:.3e} from quimb_tpu's {PEPS_QTPU_E_SITE!r} "
          f"(bound {PEPS_E_TOL:.0e})", flush=True)
    for what, val in PEPS_ARTIFACTS:
        print(f"  not gated: {what} {val} ({e_site - val:+.3e})", flush=True)
    if not diff <= PEPS_E_TOL:
        raise AssertionError("the PEPS energy misses quimb_tpu's")
    norm = psi.make_norm()
    norm.equalize_norms_(1.0)
    # a window of the energy: the first PEPS_WINDOW boundary steps of an
    # x-environment sweep (a whole compute_x_environments is 2.2 million
    # device activities, which the profiler takes minutes to process)
    share, top, wall_us, count = _busy_share(
        lambda: norm.contract_boundary_from_xmin(
            max_bond=PEPS_CHI, xrange=(0, PEPS_WINDOW)))
    print(f"{PEPS_WINDOW} boundary steps (rows 0-{PEPS_WINDOW}) of the "
          f"energy's environments under torch.profiler: "
          f"{wall_us / 1e6:.3f} s wall, {count} device activities, busy "
          "share " + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    del su, norm
    su32, _ = _peps_evolve(torch.float32, ham)
    e32 = su32.compute_energy_simple()
    rel = abs(e32 - e_simple) / abs(e_simple)
    print(f"compute_energy_simple float32: {e32!r}, relative to float64 "
          f"{rel:.3e} (bound {PEPS_F32_SIMPLE_TOL:.0e}); gesvdj redone by "
          f"gesvd {dict(decomp.SVD_REDOS)}",
          flush=True)
    if not rel <= PEPS_F32_SIMPLE_TOL:
        raise AssertionError("float32 SimpleUpdate misses the float64 energy")
    del su32
    run_circuit_peps()
    if sum(ck.LAUNCHES.values()):
        raise AssertionError(f"the PEPS phase launched sandwich kernels "
                             f"{dict(ck.LAUNCHES)}")
    print(f"PEPS phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return psi


# -- phase 17: complex DMRG ---------------------------------------------------

# the small complex128 DMRG1 and ParallelDMRG runs held to the CPU: L,
# chi, the seed of their start state, and the bounds on the energies'
# distance from the CPU's (DMRG1: the same SVDs, eighs and QRs in cuSOLVER
# and LAPACK, round-off; ParallelDMRG: its batched subspace split depends
# on each library's column phases, 7e-8 between quimb_tpu and the port)
CPLX_L, CPLX_CHI, CPLX_SEED = 16, 32, 5
CPLX_DMRG1_TOL, CPLX_PAR_TOL = 1e-9, 1e-6


def host_c128_sweep(psi, H):
    """(<psi|H|psi>, <psi|psi>) of a complex MPS under an MPO, the sweep
    of :func:`host_f64_sweep` in complex128 numpy; the real parts."""
    env = np.ones((1, 1, 1), dtype=np.complex128)
    nrm = np.ones((1, 1), dtype=np.complex128)
    for A, W in zip(_arrays(psi), _arrays(H)):
        Ah = to_host(A).astype(np.complex128)
        Wh = to_host(W).astype(np.complex128)
        env = np.einsum("bwk,kdx->bwdx", env, Ah, optimize=True)
        env = np.einsum("bwdx,wyud->byux", env, Wh, optimize=True)
        env = np.einsum("byux,bua->ayx", env, Ah.conj(), optimize=True)
        nrm = np.einsum("bk,kdx->bdx", nrm, Ah, optimize=True)
        nrm = np.einsum("bdx,bda->ax", nrm, Ah.conj(), optimize=True)
    return float(env.reshape(()).real), float(nrm.reshape(()).real)


def _small_complex_runs():
    """complex128 DMRG1 and ParallelDMRG at L=CPLX_L, chi=CPLX_CHI on the
    card against the same runs on the CPU, from one state (two DMRG2
    sweeps on the CPU from a seeded start); ParallelDMRG's split starts
    from one draw taken on the CPU. Returns the card's seconds."""
    H = quimb_torch.MPO_ham_heis(CPLX_L, dtype=torch.complex128,
                                 device="cpu")
    d2 = quimb_torch.DMRG2(H, bond_dims=CPLX_CHI, cutoffs=1e-10,
                           p0=quimb_torch.MPS_rand_state(
                               CPLX_L, 8, seed=CPLX_SEED,
                               dtype=torch.complex128, device="cpu"))
    for direction in "RL":
        d2.sweep(direction, max_bond=CPLX_CHI, cutoff=1e-10)
    psi = d2.state
    draw = decomp._random_start
    decomp._random_start = lambda shape, dtype, device, seed: draw(
        shape, dtype, "cpu", seed).to(device)
    out, secs = {}, 0.0
    try:
        for device in ("cpu", "cuda"):
            t0 = time.perf_counter()
            Hd, pd_ = H.copy(), psi.copy()
            for tn in (Hd, pd_):
                tn.apply_to_arrays(lambda a: a.to(device))
            d1 = quimb_torch.DMRG1(Hd, bond_dims=CPLX_CHI, cutoffs=1e-10,
                                   p0=pd_)
            if d1._sandwich is not ck.prepare_sandwich_reference:
                raise AssertionError("complex DMRG1 resolved a kernel")
            e1 = [d1.sweep(d, max_bond=CPLX_CHI, cutoff=1e-10,
                           canonize=d == "R") for d in "RL"]
            par = ParallelDMRG(pd_, Hd, max_bond=CPLX_CHI, n_segments=2)
            ep = [par.sweep() for _ in range(2)]
            if device == "cuda":
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            out[device] = (e1, ep)
    finally:
        decomp._random_start = draw
    card, cpu = out["cuda"], out["cpu"]
    d1_dist = max(abs(a - b) for a, b in zip(card[0], cpu[0]))
    par_dist = max(abs(a - b) for a, b in zip(card[1], cpu[1]))
    print(f"complex128 DMRG1 (L={CPLX_L}, chi={CPLX_CHI}) energies "
          f"{card[0]}, largest distance from the CPU's {d1_dist:.3e} "
          f"(bound {CPLX_DMRG1_TOL:.0e}); ParallelDMRG {card[1]}, "
          f"{par_dist:.3e} (bound {CPLX_PAR_TOL:.0e}); card {secs:.3f} s",
          flush=True)
    if not d1_dist <= CPLX_DMRG1_TOL:
        raise AssertionError("complex DMRG1 on the card misses the CPU's")
    if not par_dist <= CPLX_PAR_TOL:
        raise AssertionError("complex ParallelDMRG on the card misses the "
                             "CPU's")


def run_complex_dmrg(dmrg):
    """Phase 17: the float64 DMRG2 state cast to complex128 and swept once
    by DMRG2 at chi=256 on the card, through the plain product; its host
    energy against E_REF and one bulk bond's breakdown; then the small
    complex128 DMRG1 and ParallelDMRG runs against the CPU."""
    t_phase = time.perf_counter()
    H = quimb_torch.MPO_ham_heis(L, dtype=torch.complex128)
    if not all(t.data.is_cuda for t in H):
        raise AssertionError("MPO_ham_heis with no device is not on the GPU")
    d = quimb_torch.DMRG2(H, bond_dims=CHI, cutoffs=0.0,
                          p0=dmrg.state.astype(torch.complex128))
    _check_default_split(d, "complex128 DMRG2")
    if d._sandwich is not ck.prepare_sandwich_reference:
        raise AssertionError("complex128 DMRG2 resolved a sandwich kernel")
    _reset_launches()
    t0 = time.perf_counter()
    en = d.sweep("R", max_bond=CHI, cutoff=0.0, canonize=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if sum(ck.LAUNCHES.values()):
        raise AssertionError(f"complex128 DMRG2 launched sandwich kernels "
                             f"{dict(ck.LAUNCHES)}")
    state = d.state
    if not all(A.dtype == torch.complex128 and A.is_cuda
               for A in _arrays(state)):
        raise AssertionError("the complex128 state left the card or dtype")
    e, n = host_c128_sweep(state, H)
    rel = abs(e / n - E_REF) / abs(E_REF)
    print(f"complex128 DMRG2 sweep R max_bond={CHI}: {secs:.3f} s, energy "
          f"{en:.10f}, host float64 energy {e / n:.12f}, relative to E_REF "
          f"{rel:.3e} (bound {E_REL_TOL[torch.float64]:.0e}); sandwich "
          f"launches {dict(ck.LAUNCHES)}", flush=True)
    if not rel <= E_REL_TOL[torch.float64]:
        raise AssertionError("the complex128 DMRG2 energy misses E_REF")
    bond_breakdown(d)
    _small_complex_runs()
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the complex phase launched a sandwich kernel")
    print(f"complex DMRG phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 18: the rings ------------------------------------------------------

# the reference's own at-scale ring (tests/test_tensor/test_dmrg_cyclic.py
# ::test_cyclic_L150_segmented): L, the bond schedule of its five right
# sweeps, the segment's share of the ring and the cutoff; its bounds:
# 1e-3 relative of the Bethe-ansatz scaling energy, closure ranks at most
# 128, and <psi|psi> within 1e-2 of 1 (quimb_tpu's own test at L=30)
RING_L, RING_BONDS, RING_SEGMENT, RING_CUTOFF = 150, (10, 12, 14, 16, 16), \
    1 / 3, 1e-10
RING_E_TOL, RING_RANK_MAX, RING_NORM_TOL = 1e-3, 128, 1e-2
# quimb_tpu's float64 values of phase 18(b) and phase 19, from
# ``python scripts/slice11_reference.py`` on a CPU (see its docstring)
SLICE11_REF = "scripts/slice11_reference.json"


def _slice11_reference(part):
    return json.loads(Path(SLICE11_REF).read_text())[part]


def _ring_norm(As):
    """<psi|psi> of a ring from its uniform (chi, d, chi) arrays: the trace
    of the product of the transfer matrices, in float64 on the card, each
    partial product rescaled (its scale kept in log)."""
    chi = As[0].shape[0]
    M = torch.eye(chi * chi, dtype=As[0].dtype, device=As[0].device)
    log = 0.0
    for A in As:
        T = torch.einsum("apb,cpd->acbd", A, torch.conj(A)).reshape(
            chi * chi, chi * chi)
        M = M @ T
        s = torch.linalg.norm(M)
        M = M / s
        log += math.log(float(s))
    return float(torch.trace(M).real) * math.exp(log)


def run_ring_dmrg():
    """Phase 18(a): DMRG2 of the L=150 Heisenberg ring through the entry
    points with no device, on the segmented ring engine."""
    from quimb_torch.calc import heisenberg_energy
    from quimb_torch.tensor.tn1d import dmrg_cyclic

    t_phase = time.perf_counter()
    H = quimb_torch.MPO_ham_heis(RING_L, cyclic=True, dtype=torch.float64)
    d = quimb_torch.DMRG2(H, bond_dims=list(RING_BONDS))
    if d._cyc is None or not d.ham.cyclic:
        raise AssertionError("the L=150 ring did not take the ring engine")
    d.opts["periodic_segment_size"] = RING_SEGMENT
    eng = d._cyc
    _reset_launches()
    want = heisenberg_energy(RING_L)
    en = None
    for k, chi in enumerate(RING_BONDS):
        ranks0, reads0 = len(eng.bond_sizes), eng.host_reads
        t0 = time.perf_counter()
        en = d.sweep("R", max_bond=chi, cutoff=RING_CUTOFF)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"ring sweep {k + 1} (chi={chi}): {secs:.3f} s, energy "
              f"{en:.10f} ({(en - want) / abs(want):+.3e} from the scaling "
              f"formula), closure ranks {eng.bond_sizes[ranks0:]}, host "
              f"reads {eng.host_reads - reads0}", flush=True)
    psi = d.state
    As = dmrg_cyclic.cyclic_mps_arrays(psi)
    nrm = _ring_norm(As)
    rel = abs(en - want) / abs(want)
    rank = max(eng.bond_sizes)
    print(f"ring L={RING_L}: energy {en!r} against {want!r}, relative "
          f"{rel:.3e} (bound {RING_E_TOL:.0e}); largest closure rank {rank} "
          f"(bound {RING_RANK_MAX}); <psi|psi> {nrm!r} (bound "
          f"{RING_NORM_TOL:.0e} from 1); sandwich launches "
          f"{dict(ck.LAUNCHES)}", flush=True)
    if not psi.cyclic or not all(A.is_cuda for A in As):
        raise AssertionError("the ring state is not a cyclic MPS on the GPU")
    if not rel <= RING_E_TOL:
        raise AssertionError("the ring energy misses the scaling formula")
    if not rank <= RING_RANK_MAX:
        raise AssertionError("a closure rank exceeds its cap")
    if not abs(nrm - 1) <= RING_NORM_TOL:
        raise AssertionError("the ring state lost its norm")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the ring DMRG launched a sandwich kernel")
    print(f"ring DMRG phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# phase 18(b) runs the first RING_TEBD_STEPS of phase 10's 20 steps (steps
# 6-20 took 98 s of the 20-step phase's 115 s on an H100); the bounds
# against quimb_tpu's complex128 run on a CPU: the largest distance of the
# entropies (over 20 steps the port's card run read 3.7e-9 from its CPU
# run), and err relative. On the sequential path err adds every split's
# discarded norm to the Trotter estimate: 480 tails a step of the
# smallest singular values kept, whose relative error is the state's over
# their size (2.7e-3 between the port's card and CPU runs over 20 steps)
RING_TEBD_STEPS, RING_TEBD_ENT_TOL, RING_TEBD_ERR_TOL = 5, 1e-7, 1e-2


def run_ring_tebd():
    """Phase 18(b): the first RING_TEBD_STEPS steps of phase 10's quench on
    a ring of TEBD_L sites, complex128, bond by bond on the cyclic MPS,
    through the entry points with no device."""
    t_phase = time.perf_counter()
    ref = _slice11_reference("ring_tebd")
    if (ref["L"], ref["chi"], ref["steps"], ref["dt"], ref["cutoff"]) != (
            TEBD_L, TEBD_CHI, RING_TEBD_STEPS, TEBD_DT, TEBD_CUTOFF):
        raise AssertionError(f"{SLICE11_REF} holds another ring quench")
    psi0 = quimb_torch.MPS_neel_state(TEBD_L, cyclic=True,
                                      dtype=torch.float64)
    H = quimb_torch.ham_1d_heis(TEBD_L, cyclic=True)
    _reset_launches()
    tebd = quimb_torch.TEBD(psi0, H, split_opts={"max_bond": TEBD_CHI,
                                                 "cutoff": TEBD_CUTOFF},
                            progbar=False)
    entropies, seconds = [], []
    for k in range(1, RING_TEBD_STEPS + 1):
        t0 = time.perf_counter()
        tebd.update_to(k * TEBD_DT, dt=TEBD_DT)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        entropies.append(tebd.entropy(TEBD_L // 2))
        print(f"ring TEBD step {k}: {seconds[-1]:.4f} s, S(L/2) "
              f"{entropies[-1]:.12f}", flush=True)
    pt = tebd.pt
    if not (pt.cyclic and all(t.data.is_cuda for t in pt)
            and pt.dtype == torch.complex128):
        raise AssertionError("the ring TEBD state is not a complex128 ring "
                             "on the GPU")
    dist = np.abs(np.asarray(entropies) - np.asarray(ref["entropies"]))
    rel_err = abs(tebd.err - ref["err"]) / abs(ref["err"])
    print(f"ring TEBD: {statistics.mean(seconds):.4f} s a step (mean of "
          f"{RING_TEBD_STEPS}); entropies against quimb_tpu's: max "
          f"{dist.max():.3e} (bound {RING_TEBD_ENT_TOL:.0e}); err "
          f"{tebd.err!r} against {ref['err']!r}, relative {rel_err:.3e} "
          f"(bound {RING_TEBD_ERR_TOL:.0e}); bonds {max(pt.bond_sizes())}; "
          f"sandwich launches {dict(ck.LAUNCHES)}", flush=True)
    if not dist.max() <= RING_TEBD_ENT_TOL:
        raise AssertionError("the ring TEBD entropies miss quimb_tpu's")
    if not rel_err <= RING_TEBD_ERR_TOL:
        raise AssertionError("the ring TEBD err misses quimb_tpu's")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the ring TEBD launched a sandwich kernel")
    print(f"ring TEBD phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 19: the rest of the 2D layer ----------------------------------------

# bounds on each 16x16 norm (the unit-scaled state's, close to 1) relative
# to quimb_tpu's value of the same method (the port's CPU run reads 2e-14
# from it, and the card's SimpleUpdate gauges 2.3e-13 from the CPU's), and
# relative to the port's own "mps"-mode value: twice quimb_tpu's own
# distances (1.3e-4 full-bond, 1.0e-2 CTMRG, 4.4e-3 HOTRG). HOTRG runs at
# max_bond HOTRG_CHI: its second merges hold tensors of chi**6 entries,
# 8 GB each at chi=32, and a row of them ran the 80 GB card out of memory
NORM_QTPU_TOL = {"mps": 1e-8, "full_bond": 1e-8, "ctmrg": 1e-8,
                 "hotrg": 1e-8}
NORM_MPS_TOL = {"mps": 0.0, "full_bond": 3e-4, "ctmrg": 2e-2,
                "hotrg": 1e-2}
HOTRG_CHI = 16
# FullUpdate: the lattice and schedule of scripts/slice11_reference.py, and
# the bound on the energy's distance from quimb_tpu's float64 value
FU_L, FU_D, FU_CHI, FU_SCHEDULE = 4, 3, 32, ((1, 0.3), (1, 0.1))
FU_E_TOL = 1e-8


def unit_state(psi, chi):
    """``psi`` scaled in place so that ``<psi|psi>`` is close to 1, as
    scripts/slice11_reference.py scales quimb_tpu's: every site tensor to
    norm 1, then all by one factor from ``log10 <psi|psi>`` read off the
    last row's ``xmin`` environment at ``chi`` (mantissa and exponent).
    The state's own ``exponent`` is dropped (its scale is irrelevant)."""
    psi.exponent = 0.0
    for t in psi:
        t.modify(apply=lambda d: d / torch.linalg.norm(d))
    norm = psi.make_norm()
    env = norm.compute_x_environments(max_bond=chi)["xmin", psi.Lx - 1]
    last = quimb_torch.TensorNetwork(tuple(env) + tuple(
        norm.select(norm.x_tag(psi.Lx - 1), which="any")), virtual=False)
    log10 = math.log10(abs(complex(last.contract(...)))) + env.exponent
    f = 10.0 ** (-log10 / (2 * psi.num_tensors))
    for t in psi:
        t.modify(apply=lambda d: d * f)
    return psi


def run_peps_norms(psi):
    """Phase 19(a): the 16x16 SimpleUpdate state's norm at chi=32 by the
    "mps" and "full-bond" boundary modes and CTMRG, and by HOTRG at
    chi=HOTRG_CHI."""
    ref = _slice11_reference("peps16_norms")
    if (ref["L"], ref["D"], ref["chi"]) != (PEPS_L, PEPS_D, PEPS_CHI):
        raise AssertionError(f"{SLICE11_REF} holds other norms")
    _reset_launches()
    norm = unit_state(psi.copy(), PEPS_CHI).make_norm()
    calls = {
        "mps": lambda tn: tn.contract_boundary(max_bond=PEPS_CHI),
        "full_bond": lambda tn: tn.contract_boundary(max_bond=PEPS_CHI,
                                                     mode="full-bond"),
        "ctmrg": lambda tn: tn.contract_ctmrg(max_bond=PEPS_CHI),
        "hotrg": lambda tn: tn.contract_hotrg(max_bond=HOTRG_CHI),
    }
    vals = {}
    for name, fn in calls.items():
        tn = norm.copy()
        val, secs = _timed(lambda: fn(tn))
        vals[name] = float(np.real(complex(val)))
        rm = abs(vals[name] - vals["mps"]) / abs(vals["mps"])
        q = ref[name]["value"]
        rq = abs(vals[name] - q) / abs(q)
        print(f"16x16 norm by {name}: {vals[name]!r} ({secs:.3f} s; "
              f"quimb_tpu's host run {ref[name]['seconds']:.1f} s), "
              f"relative to quimb_tpu's {q!r} {rq:.3e} (bound "
              f"{NORM_QTPU_TOL[name]:.0e}), to the mps mode's {rm:.3e} "
              f"(bound {NORM_MPS_TOL[name]:.0e})", flush=True)
        if not (math.isfinite(vals[name]) and rq <= NORM_QTPU_TOL[name]
                and rm <= NORM_MPS_TOL[name]):
            raise AssertionError(f"the 16x16 norm by {name} misses its "
                                 f"bounds")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the 2D contractions launched a sandwich "
                             "kernel")


def run_full_update():
    """Phase 19(b): FullUpdate (ALS) and SimpleUpdate of the FU_L x FU_L
    Heisenberg model at D=3, chi=32 from the start arrays, on the
    reference's schedule, through the entry points with no device."""
    ref = _slice11_reference("full_update")
    if (ref["L"], ref["D"], ref["chi"], ref["schedule"]) != (
            FU_L, FU_D, FU_CHI, [list(s) for s in FU_SCHEDULE]):
        raise AssertionError(f"{SLICE11_REF} holds another FullUpdate run")
    _reset_launches()
    ham = quimb_torch.ham_2d_heis(FU_L, FU_L)
    out = {}
    for name, cls, kw in (
            ("full_update", quimb_torch.FullUpdate, {}),
            ("simple_update", quimb_torch.SimpleUpdate,
             {"compute_energy_every": None})):
        psi0 = quimb_torch.PEPS([[a for a in row] for row in
                                 peps_start_arrays(FU_L, FU_D)])
        ev = cls(psi0, ham, D=FU_D, chi=FU_CHI, compute_energy_final=False,
                 **kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        energies, secs, syncs = [], 0.0, None
        for steps, tau in FU_SCHEDULE:
            if name == "full_update" and syncs is None:
                with _counted_syncs() as syncs:
                    _, t = _timed(lambda: ev.evolve(1, tau=tau))
                secs += t
                steps -= 1
            _, t = _timed(lambda: ev.evolve(steps, tau=tau))
            secs += t
            energies.append(ev.compute_energy())
        peak = torch.cuda.max_memory_allocated() - base
        out[name] = energies
        gates = sum(s for s, _ in FU_SCHEDULE) * len(ham.terms)
        if not ev.state["I0,0"].data.is_cuda:
            raise AssertionError(f"{name} left the card")
        print(f"{name} {FU_L}x{FU_L}, D={FU_D}, chi={FU_CHI}: energies "
              f"{energies} after each stage; {secs:.3f} s, "
              f"{secs / gates:.4f} s a gate ({gates} gates; quimb_tpu's "
              f"host run {ref[name]['seconds']:.1f} s); peak allocation "
              f"{peak / 1e9:.4f} GB" + (
                  f"; {len(syncs) / len(ham.terms):.1f} host syncs a gate"
                  if syncs is not None else ""), flush=True)
    fu, su = out["full_update"][-1], out["simple_update"][-1]
    q = ref["full_update"]["energies"][-1]
    print(f"FullUpdate energy {fu!r} against SimpleUpdate's {su!r} and "
          f"quimb_tpu's {q!r}: {abs(fu - q):.3e} (bound {FU_E_TOL:.0e})",
          flush=True)
    if not fu < su:
        raise AssertionError("FullUpdate does not beat SimpleUpdate")
    if not abs(fu - q) <= FU_E_TOL * abs(q):
        raise AssertionError("the FullUpdate energy misses quimb_tpu's")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("FullUpdate launched a sandwich kernel")

# -- phase 20: JacobiDMRG at the north star ------------------------------------

# one sweep with the damped local solves of quimb_tpu's own test of the
# engine (tests/test_tensor/test_dmrg_parallel.py::TestJacobiDMRG: ncv=2,
# the other defaults stride=2, oversample=16, power_iters=3), and the bound
# on <psi|psi> of the renormalised stack, read on the host in float64. The
# engine's fixed point does not hold, in quimb_tpu as in the port (ROADMAP
# section 3, scripts/jacobi_fixed_point.py): three default (ncv=8) sweeps
# of a converged L=32, chi=32 chain rise 1.05e-3 in both on a CPU, and at
# L=128, chi=256 one ncv=2 sweep rises 2.65e-2 in quimb_tpu (on a CPU) and
# 2.64e-2 in the port (on the card) from the same state. The energy's
# distance from the DMRG2 start and from E_REF is printed, not gated, and
# no later sweep runs (a diverging sweep can meet a norm environment that
# is not positive definite)
JAC_NCV, JAC_NORM_TOL = 2, 1e-8


def run_jacobi(dmrg2):
    """Phase 20: JacobiDMRG from the float64 DMRG2 state (L=128, chi=256,
    the same MPO), one sweep with the damped solves of quimb_tpu's test of
    the engine, read back on the host."""
    from quimb_torch.tensor.tn1d.dmrg_jacobi import (
        JacobiDMRG, _jacobi_halfsweep)

    t_phase = time.perf_counter()
    H = dmrg2.ham
    e0 = host_f64_energy(dmrg2.state, H)
    _reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    jd, secs = _timed(lambda: JacobiDMRG(dmrg2.state, H, max_bond=CHI,
                                         ncv=JAC_NCV))
    print(f"JacobiDMRG L={L}, chi={CHI}, ncv={JAC_NCV}: stacks "
          f"{tuple(jd.Ms.shape)} {jd.Ms.dtype} built in {secs:.3f} s",
          flush=True)
    # a half-sweep of the start state under the profiler (its result is
    # dropped)
    share, top, wall_us, count = _busy_share(lambda: _jacobi_halfsweep(
        jd.Ms, jd.Ws, 0, jd.ncv, jd.chi, stride=jd.stride,
        oversample=jd.oversample, power_iters=jd.power_iters))
    print(f"one even half-sweep under torch.profiler: {wall_us / 1e6:.3f} s "
          f"wall, {count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    en, secs = _timed(jd.sweep)
    peak = torch.cuda.max_memory_allocated() - base
    psi = jd.get_state()
    As = _arrays(psi)
    if not all(A.is_cuda and A.dtype == torch.float64
               and bool(torch.isfinite(A).all()) for A in As):
        raise AssertionError("the Jacobi state left the card, or is not "
                             "finite float64")
    eh, nrm = host_f64_sweep(psi, H)
    e = eh / nrm
    rel = abs(e - E_REF) / abs(E_REF)
    print(f"JacobiDMRG sweep: {secs:.3f} s, mean Ritz energy {en!r}; peak "
          f"allocation {peak / 1e9:.3f} GB; host float64 <psi|psi> {nrm!r} "
          f"(bound {JAC_NORM_TOL:.0e} from 1); not gated: host energy "
          f"{e!r}, {e - e0:+.3e} from the DMRG2 start {e0!r}, {rel:.3e} "
          f"relative to E_REF", flush=True)
    if not (math.isfinite(en) and abs(nrm - 1) <= JAC_NORM_TOL):
        raise AssertionError("the Jacobi sweep lost the state's norm")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("JacobiDMRG launched a sandwich kernel")
    print(f"JacobiDMRG phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 21: the arbitrary-geometry layer ------------------------------------

# quimb_tpu's float64 values of phase 21, from
# ``python scripts/slice12_reference.py`` on a CPU (see its docstring)
SLICE12_REF = "scripts/slice12_reference.json"
# the kagome Heisenberg antiferromagnet: the open 6 x 6 lattice (108
# sites), D=4, one imaginary-time step at each tau (ten until the 3D and
# BP phases were added, five until phases 24-25 were, two until phases
# 26-28 were); the cluster energy's simple gauging capped at 20
# iterations (at 100 it ran to its cap without reaching its tolerance,
# 45-55 s on the card); the bound on the energy per site relative to
# quimb_tpu's of the same protocol from the same start arrays
# (scripts/slice13_reference.py, part "kagome")
KAGOME_L, KAGOME_D, KAGOME_NITS, KAGOME_TAUS = 6, 4, 1, (0.3, 0.1, 0.03)
KAGOME_GAUGE_ITERATIONS = 20
KAGOME_E_TOL, KAGOME_THREADS = 1e-6, 4
# <Z_q> of phase 16's 4x4 circuit by CircuitPEPOSimpleUpdate, against the
# port's exact Circuit on the card
CPEPO_TOL = 1e-10


def _slice12_reference(part):
    return json.loads(Path(SLICE12_REF).read_text())[part]


def run_kagome():
    """Phase 21(a): SimpleUpdateGen of the kagome Heisenberg model through
    the entry points with no device, and its cluster energy."""
    t_phase = time.perf_counter()
    ref = _slice13_reference("kagome")
    if (ref["L"], ref["D"], ref["nits"], tuple(ref["taus"]),
            ref["gauge_iterations"]) != (KAGOME_L, KAGOME_D, KAGOME_NITS,
                                         KAGOME_TAUS,
                                         KAGOME_GAUGE_ITERATIONS):
        raise AssertionError(f"{SLICE13_REF} holds another kagome run")
    edges = quimb_torch.edges_2d_kagome(KAGOME_L, KAGOME_L)
    rng = np.random.default_rng(42)
    psi0 = quimb_torch.TN_from_edges_and_fill_fn(
        lambda shape: rng.standard_normal(shape), edges, KAGOME_D,
        phys_dim=2)
    ham = quimb_torch.ham_gen_heis(edges)
    if not all(t.data.is_cuda and t.dtype == torch.float64 for t in psi0):
        raise AssertionError("the kagome state is not float64 on the card")
    _reset_launches()
    su = quimb_torch.SimpleUpdateGen(psi0, ham, D=KAGOME_D,
                                     compute_energy_final=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nb = len(ham.terms)
    with _counted_syncs() as syncs:
        _, secs = _timed(lambda: su.evolve(1, tau=KAGOME_TAUS[0]))
    for k, tau in enumerate(KAGOME_TAUS):
        _, t = _timed(lambda: su.evolve(KAGOME_NITS - (k == 0), tau=tau))
        secs += t
    steps = KAGOME_NITS * len(KAGOME_TAUS)
    print(f"SimpleUpdateGen kagome {KAGOME_L}x{KAGOME_L} ({psi0.nsites} "
          f"sites, {nb} bonds), D={KAGOME_D}: {steps} steps in {secs:.3f} s, "
          f"{secs / steps:.4f} s a step, {steps * nb / secs:.1f} gates a "
          f"second; {len(syncs) / nb:.2f} host syncs a gate "
          f"({sorted(set(syncs))[:3]})", flush=True)
    # compute_local_expectation(method="cluster") in its two stages: the
    # simple gauges of the state, then the clusters, their host work
    # overlapped by a thread pool
    psi = su.get_state()
    # the busy share over one gauging iteration of a copy (a whole step,
    # 121,339 device activities, took the profiler seconds to process)
    share, top, wall_us, count = _busy_share(
        lambda: psi.gauge_all_simple(max_iterations=1, gauges={}))
    print(f"one gauge_all_simple iteration ({nb} bond splits, the gate's "
          f"operations) under torch.profiler: {wall_us / 1e6:.3f} s wall, "
          f"{count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    gauges = {}
    tn, gsecs = _timed(lambda: psi.gauge_all_simple(
        max_iterations=KAGOME_GAUGE_ITERATIONS, gauges=gauges))
    with ThreadPoolExecutor(KAGOME_THREADS) as ex:
        e, csecs = _timed(lambda: tn.compute_local_expectation(
            ham.terms, method="cluster", gauges=gauges, executor=ex))
    esecs = gsecs + csecs
    peak = torch.cuda.max_memory_allocated() - base
    e_site = float(np.real(e)) / psi0.nsites
    rel = abs(e_site - ref["energy_per_site"]) / abs(ref["energy_per_site"])
    print(f"kagome cluster energy: {esecs:.3f} s (gauges, "
          f"{KAGOME_GAUGE_ITERATIONS} iterations, {gsecs:.3f} s, "
          f"{nb} clusters on {KAGOME_THREADS} threads {csecs:.3f} s); "
          f"E/site {e_site!r}, "
          f"quimb_tpu's {ref['energy_per_site']!r} (its host run "
          f"{ref['energy_seconds']:.1f} s), relative {rel:.3e} (bound "
          f"{KAGOME_E_TOL:.0e}); peak allocation {peak / 1e9:.4f} GB",
          flush=True)
    if not all(t.data.is_cuda for t in su.state):
        raise AssertionError("SimpleUpdateGen left the card")
    if not rel <= KAGOME_E_TOL:
        raise AssertionError("the kagome energy misses quimb_tpu's")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("SimpleUpdateGen launched a sandwich kernel")
    print(f"kagome phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# the 2D compressions of phase 21(b): the methods, and for each the
# cases (state, max_bond) of scripts/slice12_reference.py; the bound on
# the normalised overlap with psi relative to quimb_tpu's value of the same
# protocol, for the truncation of psi to bond 2 (non-degenerate spectra).
# phi = psi + psi to bond 3 is timed and checked for its bond, not
# contracted: each bond's spectrum there is doubly degenerate, and which
# half of each pair a truncation keeps rests on the SVD's rounding (on the
# card the overlaps read 0.8784 and 0.3872 against quimb_tpu's 0.8783 and
# 0.4763 on a CPU)
COMPRESS_METHODS = ("local-early", "superorthogonal")
COMPRESS_CASES = (("phi", 3), ("psi", 2))
COMPRESS_TOL = 1e-8


def _compress_fidelity(c, psi, psi_norm):
    """``|<c|psi>| / (|c| |psi|)`` by the boundary method at PEPS_CHI, each
    site tensor of ``c`` first scaled to the norm of ``psi``'s (the
    fidelity of scripts/slice12_reference.py)."""
    for site in psi.site_tags:
        (tc,), (tp,) = c.select_tensors(site), psi.select_tensors(site)
        f = torch.linalg.norm(tp.data) / torch.linalg.norm(tc.data)
        tc.modify(apply=lambda d, f=f: d * f)
    cp = complex(psi.make_overlap(c).view_like_(psi).contract_boundary(
        max_bond=PEPS_CHI))
    cc = complex(c.make_norm().contract_boundary(max_bond=PEPS_CHI))
    return abs(cp) / math.sqrt(abs(cc) * abs(psi_norm))


def run_2d_compress(psi16):
    """Phase 21(b): the 16x16 float64 state scaled to norm close to 1, its
    direct sum with itself, and 2D compressions of both by the two methods,
    each held by its normalised overlap with the state."""
    t_phase = time.perf_counter()
    ref = _slice12_reference("compress")
    if (ref["L"], ref["D"], ref["chi"]) != (PEPS_L, PEPS_D, PEPS_CHI):
        raise AssertionError(f"{SLICE12_REF} holds other compressions")
    _reset_launches()
    psi = unit_state(psi16.copy(), PEPS_CHI)
    psi_norm, secs = _timed(lambda: complex(psi.make_norm().contract_boundary(
        max_bond=PEPS_CHI)))
    print(f"<psi|psi> by the boundary at {PEPS_CHI}: {psi_norm.real!r} "
          f"({secs:.3f} s), quimb_tpu's {ref['psi_norm']!r}", flush=True)
    phi, secs = _timed(lambda: psi.add_PEPS(psi))
    # the direct sum, exactly: each site tensor of phi holds psi's in the
    # diagonal blocks of its bonds and zeros elsewhere
    worst = 0.0
    for site in psi.site_tags:
        (tp,), (tf,) = psi.select_tensors(site), phi.select_tensors(site)
        A, F = tp.data, tf.transpose(*tp.inds).data
        blocks = [slice(None) if ix in psi.site_inds else None
                  for ix in tp.inds]
        lo = tuple(s or slice(0, n) for s, n in zip(blocks, A.shape))
        hi = tuple(s or slice(n, 2 * n) for s, n in zip(blocks, A.shape))
        rest = F.clone()
        rest[lo] = 0.0
        rest[hi] = 0.0
        worst = max(worst, float((F[lo] - A).abs().max()),
                    float((F[hi] - A).abs().max()), float(rest.abs().max()))
    print(f"add_PEPS: {secs:.3f} s, bonds {phi.max_bond()}; the blocks' "
          f"largest distance from psi {worst:.1e} (bound 0)", flush=True)
    if not (worst == 0.0 and phi.max_bond() == 2 * PEPS_D
            and all(t.data.is_cuda for t in phi)):
        raise AssertionError("add_PEPS is not the direct sum on the card")
    for method in COMPRESS_METHODS:
        for which, mb in COMPRESS_CASES:
            src = phi if which == "phi" else psi
            c, secs = _timed(lambda: quimb_torch.tensor_network_2d_compress(
                src, max_bond=mb, method=method))
            want = ref[f"{method} {which} {mb}"]
            print(f"{method} {which} -> {mb}: {secs:.3f} s (quimb_tpu's "
                  f"host run {want['compress_seconds']:.1f} s), bonds "
                  f"{c.max_bond()}", flush=True)
            if not (c.max_bond() == mb and all(t.data.is_cuda for t in c)):
                raise AssertionError(f"{method} left the card or the bond")
            if which == "phi":
                continue
            f, fsecs = _timed(lambda: _compress_fidelity(c, psi, psi_norm))
            rel = abs(f - want["fidelity"]) / want["fidelity"]
            print(f"  normalised overlap with psi {f!r} ({fsecs:.3f} s), "
                  f"quimb_tpu's {want['fidelity']!r}, relative {rel:.3e} "
                  f"(bound {COMPRESS_TOL:.0e})", flush=True)
            if not rel <= COMPRESS_TOL:
                raise AssertionError(f"{method} misses quimb_tpu's overlap")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the 2D compressions launched a sandwich "
                             "kernel")
    print(f"2D compression phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def circuit_peps_gates():
    """The gates of the 4x4 circuit of phase 16 (and of
    scripts/slice12_reference.py's ``cpeps_gates``) and the generator that
    drew them."""
    rng = np.random.default_rng(CPEPS_SEED)
    n, Ly = CPEPS_L * CPEPS_L, CPEPS_L
    pairs = [[], [], [], []]  # horizontal even / odd, vertical even / odd
    for i in range(CPEPS_L):
        for j in range(Ly):
            q = i * Ly + j
            if j + 1 < Ly:
                pairs[j % 2].append((q, q + 1))
            if i + 1 < CPEPS_L:
                pairs[2 + i % 2].append((q, q + Ly))
    gates = []
    for _ in range(CPEPS_DEPTH):
        gates += [("U3", *rng.uniform(0, 2 * np.pi, 3), q) for q in range(n)]
        gates += [("CZ", *pq) for cls in pairs for pq in cls]
    return gates, rng


def run_circuit_pepo():
    """Phase 21(c): <Z_q> of every qubit of phase 16's 4x4 circuit by
    CircuitPEPOSimpleUpdate at the bond of quimb_tpu's exact run, against
    the port's Circuit, both on the card."""
    ref = _slice12_reference("circuit_pepo")
    if (ref["L"], ref["depth"], ref["seed"]) != (CPEPS_L, CPEPS_DEPTH,
                                                 CPEPS_SEED):
        raise AssertionError(f"{SLICE12_REF} holds another circuit")
    _reset_launches()
    gates, _ = circuit_peps_gates()
    n = CPEPS_L * CPEPS_L
    Z = np.diag([1.0, -1.0])
    cp = quimb_torch.CircuitPEPOSimpleUpdate(N=n, max_bond=ref["max_bond"])
    cp.apply_gates(gates)
    exact = quimb_torch.Circuit(N=n)
    exact.apply_gates(gates)
    if not all(U.is_cuda for U, _ in cp._recorded):
        raise AssertionError("CircuitPEPOSimpleUpdate's gates are not on "
                             "the card")
    got, secs = _timed(lambda: [complex(cp.local_expectation(Z, q)).real
                                for q in range(n)])
    want = [complex(exact.local_expectation(Z, q)).real for q in range(n)]
    dist = max(abs(a - b) for a, b in zip(got, want))
    dq = max(abs(a - b) for a, b in zip(got, ref["z"]))
    print(f"CircuitPEPOSimpleUpdate {CPEPS_L}x{CPEPS_L}, depth "
          f"{CPEPS_DEPTH}, max_bond {ref['max_bond']}: {n} <Z_q> in "
          f"{secs:.3f} s ({secs / n:.4f} s each); largest distance from the "
          f"port's Circuit {dist:.3e} (bound {CPEPO_TOL:.0e}), from "
          f"quimb_tpu's values {dq:.3e}", flush=True)
    if not dist <= CPEPO_TOL:
        raise AssertionError("CircuitPEPOSimpleUpdate misses Circuit")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("CircuitPEPOSimpleUpdate launched a sandwich "
                             "kernel")


# -- phases 22-23: the 3D layer and belief propagation --------------------------

# quimb_tpu's float64 values of phases 21(a) and 22-23, from
# ``python scripts/slice13_reference.py`` on a CPU (see its docstring)
SLICE13_REF = "scripts/slice13_reference.json"
# the 3D classical Ising model at its critical coupling: the exact value
# at 2 x 2 x 2 (against a sum over the 256 configurations) and 3 x 3 x 3,
# then (method, L, max_bond) of the truncated contractions; the bounds on
# log Z relative to quimb_tpu's value of the same protocol
BETA_C = 0.2216544
ISING_EXACT_L, ISING_EXACT_TOL = 3, 1e-12
ISING_RUNS = (("ctmrg", 8, 16), ("boundary", 6, 12), ("hotrg", 6, 8))
ISING_TOL = 1e-8
# the lattice of the BP gauge's check (phase 23(a)): its 1-norm BP
# converges on this positive network
ISING_GAUGE_L = 6
# SimpleUpdate3D of the 3D Heisenberg antiferromagnet: a 4 x 4 x 4 PEPS3D
# at D=3 from default_rng(42), two steps at each tau (five until phases
# 24-25 were added); the bounds on the
# gauges and on the BP energy (D2BP over the 144 bonds), and the boundary
# bond of the (not gated) norm
P3D_L, P3D_D, P3D_NITS, P3D_TAUS, P3D_SEED = 4, 3, 2, (0.3, 0.1, 0.03), 42
P3D_GAUGE_TOL, P3D_E_TOL, P3D_NORM_CHI = 1e-6, 1e-6, 9
# D2BP on phase 16's state: the bound on the BP norm, energy and the site
# tensors' norms after compress_d2bp (and after the BP gauge of the Ising
# network); compress_d2bp's bond
BP16_TOL, BP16_MAX_BOND = 1e-8, 2
# 1-norm BP on hyper networks: the Ising field and lattice sizes (HV1BP
# at 8 x 8 x 8, the per-message D1BP and HV1BP at 4 x 4 x 4), random 3-SAT
# counting; the bounds on log Z relative to quimb_tpu's and between the two
# engines at one fixed point (each run to its tolerance of 5e-6)
HYPER_H, HYPER_L, HYPER_L_D1 = 0.1, 8, 4
KSAT = dict(k=3, num_variables=1000, alpha=3.0, seed=7)
HYPER_TOL, HYPER_ENGINES_TOL = 1e-8, 1e-6


def _slice13_reference(part):
    return json.loads(Path(SLICE13_REF).read_text())[part]


@contextlib.contextmanager
def _calls(cls, name):
    """Yields a list whose one entry counts the calls of ``cls.name``
    made inside."""
    count = [0]
    orig = getattr(cls, name)

    def counted(*args, **kwargs):
        count[0] += 1
        return orig(*args, **kwargs)

    setattr(cls, name, counted)
    try:
        yield count
    finally:
        setattr(cls, name, orig)


def _peak_from(base):
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def _fresh_peak():
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _ising_log_z(tn, method, chi):
    """The natural log of the 3D Ising network's value by ``method``."""
    if method == "exact":
        z = tn.contract(...)
    elif method == "ctmrg":
        z = tn.contract_ctmrg(max_bond=chi)
    elif method == "boundary":
        z = tn.contract_boundary(max_bond=chi)
    else:
        z = tn.contract_hotrg(max_bond=chi)
    return math.log(abs(complex(z))) + tn.exponent * math.log(10)


def _ising_brute_z(L, beta):
    """The 3D Ising partition function of an L x L x L lattice, summed
    over every configuration on the host."""
    import itertools

    coos = list(itertools.product(range(L), repeat=3))
    index = {c: k for k, c in enumerate(coos)}
    spins = 1 - 2 * ((np.arange(2 ** len(coos))[:, None]
                      >> np.arange(len(coos))) & 1)
    energy = sum(spins[:, index[a]] * spins[:, index[b]]
                 for a, b in quimb_torch.gen_3d_bonds(L, L, L))
    return float(np.exp(beta * energy).sum())


def _ising(L):
    tn = quimb_torch.TN3D_classical_ising_partition_function(
        L, L, L, beta=BETA_C)
    if not all(t.data.is_cuda and t.dtype == torch.float64 for t in tn):
        raise AssertionError("the 3D Ising network is not float64 on the "
                             "card")
    return tn


def run_ising_3d():
    """Phase 22(a): the 3D classical Ising model at its critical point,
    exact and by CTMRG, the boundary sweep and HOTRG, each log Z held to
    quimb_tpu's."""
    t_phase = time.perf_counter()
    ref = _slice13_reference("ising3d")
    if ref["beta"] != BETA_C:
        raise AssertionError(f"{SLICE13_REF} holds another Ising coupling")
    _reset_launches()
    z2, secs = _timed(lambda: complex(_ising(2).contract(...)).real)
    brute = _ising_brute_z(2, BETA_C)
    rel2 = abs(z2 - brute) / brute
    print(f"3D Ising 2x2x2 exact on the card: Z {z2!r} ({secs:.3f} s), the "
          f"sum over 256 configurations {brute!r}, relative {rel2:.3e} "
          f"(bound {ISING_EXACT_TOL:.0e})", flush=True)
    if not rel2 <= ISING_EXACT_TOL:
        raise AssertionError("the 2x2x2 Ising value misses the sum")
    runs = (("exact", ISING_EXACT_L, None), *ISING_RUNS)
    for method, L, chi in runs:
        want = ref[f"{method} {L} {chi}"]
        tn = _ising(L)
        base = _fresh_peak()
        with _calls(quimb_torch.TensorNetwork,
                    "_compress_between_tids") as calls:
            logz, secs = _timed(lambda: _ising_log_z(tn, method, chi))
        if method == "exact":
            # Z itself, relative: the distance of the logs
            rel, what = abs(math.expm1(logz - want["log_z"])), "Z"
        else:
            rel, what = abs(logz - want["log_z"]) / abs(want["log_z"]), "log Z"
        bound = ISING_EXACT_TOL if method == "exact" else ISING_TOL
        print(f"3D Ising {method} L={L} max_bond={chi}: {secs:.3f} s "
              f"(quimb_tpu's host run {want['seconds']:.1f} s), peak "
              f"allocation {_peak_from(base):.4f} GB, {calls[0]} "
              f"compress_between calls ({calls[0] / secs:.1f} a second); "
              f"log Z / site {logz / L ** 3!r}, quimb_tpu's "
              f"{want['log_z_per_site']!r}, {what} relative {rel:.3e} "
              f"(bound {bound:.0e})", flush=True)
        if not rel <= bound:
            raise AssertionError(f"the 3D Ising {method} value misses "
                                 f"quimb_tpu's")
    # a short window: one plane of the L=8 CTMRG absorbed and compressed
    tn = _ising(ISING_RUNS[0][1])
    window = functools.partial(tn.contract_boundary_from, "xmin",
                               max_bond=ISING_RUNS[0][2], xrange=(0, 1))
    syncs = _syncs(window)
    share, top, wall_us, count = _busy_share(window)
    print(f"one plane absorbed at L={ISING_RUNS[0][1]} under torch.profiler: "
          f"{wall_us / 1e6:.3f} s wall, {count} device activities, {syncs} "
          f"host syncs, busy share "
          + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the 3D contractions launched a sandwich kernel")
    print(f"3D Ising phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _bond_sites(psi, ix):
    """The two site coordinates of a PEPS3D bond, as the key of
    scripts/slice13_reference.py's gauges."""
    coos = []
    for tid in psi.ind_map[ix]:
        tag = next(t for t in psi.tensor_map[tid].tags if t.startswith("I"))
        coos.append(tuple(int(v) for v in tag[1:].split(",")))
    return "|".join(",".join(map(str, c)) for c in sorted(coos))


def _heis_h2():
    return quimb_torch.ham_3d_heis(1, 1, 2).get_term(((0, 0, 0), (0, 0, 1)))


def run_peps3d():
    """Phase 22(b): SimpleUpdate3D of the 3D Heisenberg model on a 4 x 4 x
    4 PEPS3D, its gauges and BP energy held to quimb_tpu's."""
    from quimb_torch.tensor.belief_propagation import D2BP

    t_phase = time.perf_counter()
    ref = _slice13_reference("peps3d")
    if (ref["L"], ref["D"], ref["nits"], tuple(ref["taus"]),
            ref["seed"]) != (P3D_L, P3D_D, P3D_NITS, P3D_TAUS, P3D_SEED):
        raise AssertionError(f"{SLICE13_REF} holds another PEPS3D run")
    _reset_launches()
    L = P3D_L
    rng = np.random.default_rng(P3D_SEED)
    psi0 = quimb_torch.PEPS3D.from_fill_fn(
        lambda s: rng.standard_normal(s), L, L, L, P3D_D)
    if not all(t.data.is_cuda and t.dtype == torch.float64 for t in psi0):
        raise AssertionError("the PEPS3D is not float64 on the card")
    ham = quimb_torch.ham_3d_heis(L, L, L)
    nb = len(ham.terms)
    su = quimb_torch.SimpleUpdate3D(psi0, ham, D=P3D_D)
    base = _fresh_peak()
    with _counted_syncs() as syncs:
        _, secs = _timed(lambda: su.evolve(1, P3D_TAUS[0]))
    for k, tau in enumerate(P3D_TAUS):
        _, t = _timed(lambda: su.evolve(P3D_NITS - (k == 0), tau))
        secs += t
    steps = P3D_NITS * len(P3D_TAUS)
    print(f"SimpleUpdate3D {L}x{L}x{L} ({nb} bonds), D={P3D_D}: {steps} "
          f"steps in {secs:.3f} s (quimb_tpu's host run "
          f"{ref['su_seconds']:.1f} s), {secs / steps:.4f} s a step, "
          f"{steps * nb / secs:.1f} gates a second, {len(syncs) / nb:.2f} "
          f"host syncs a gate, peak allocation {_peak_from(base):.4f} GB; "
          f"state {su.state.dtype}", flush=True)
    if not all(t.data.is_cuda for t in su.state):
        raise AssertionError("SimpleUpdate3D left the card")
    got = {_bond_sites(su.state, ix): s for ix, s in su.gauges.items()}
    if set(got) != set(ref["gauges"]):
        raise AssertionError("SimpleUpdate3D's gauges sit on other bonds")
    gerr = max(float(np.abs(to_host(got[k]) - np.asarray(v)).max())
               for k, v in ref["gauges"].items())
    print(f"  {len(got)} gauge vectors, largest distance from quimb_tpu's "
          f"{gerr:.3e} (bound {P3D_GAUGE_TOL:.0e})", flush=True)
    if not gerr <= P3D_GAUGE_TOL:
        raise AssertionError("the 3D gauges miss quimb_tpu's")
    # the busy share over one more sweep of a copy (144 gates)
    more = quimb_torch.SimpleUpdate3D(su.state, ham, D=P3D_D)
    more.gauges = dict(su.gauges)
    share, top, wall_us, count = _busy_share(
        lambda: more.evolve(1, P3D_TAUS[-1]))
    print(f"  one sweep of a copy under torch.profiler: {wall_us / 1e6:.3f} s "
          f"wall, {count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top[:3]:
        print(f"    {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    psi = su.get_state()
    h2 = _heis_h2()
    bp = D2BP(psi)
    with _counted_syncs() as syncs:
        _, bsecs = _timed(bp.run)
    e, esecs = _timed(lambda: sum(bp.local_expectation(h2, where)
                                  for where in ham.terms).real)
    rel = abs(e - ref["bp_energy"]) / abs(ref["bp_energy"])
    print(f"  D2BP: {bp.n_iter} iterations in {bsecs:.3f} s (quimb_tpu's "
          f"{ref['bp_iterations']}), {len(syncs) / max(bp.n_iter, 1):.1f} "
          f"host reads an iteration; BP energy of {nb} bonds {e!r} "
          f"({esecs:.3f} s), quimb_tpu's {ref['bp_energy']!r}, relative "
          f"{rel:.3e} (bound {P3D_E_TOL:.0e})", flush=True)
    if not rel <= P3D_E_TOL:
        raise AssertionError("the 3D BP energy misses quimb_tpu's")
    mant, expo = bp.contract(strip_exponent=True)
    bp_log10 = expo + math.log10(abs(complex(mant)))
    # the boundary norm is reckoned, not run: its first plane merge joins
    # the ket and bra of two planes, D**4 per in-plane bond, before any
    # compression
    entries = (P3D_D ** 4) ** 4 * P3D_D ** 2
    print(f"  log10 <psi|psi> by BP {bp_log10:.6f}; norm2(max_bond="
          f"{P3D_NORM_CHI}) by the boundary not run: its first plane merge "
          f"builds an interior site tensor of {entries} entries "
          f"({entries * 16 / 1e9:.1f} GB in complex128) before it "
          f"compresses", flush=True)
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("SimpleUpdate3D launched a sandwich kernel")
    print(f"PEPS3D phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _site_norms(tn, tags):
    return {t: float(torch.linalg.norm(tn[t].data)) for t in tags}


def _norms_err(got, want):
    return max(abs(got[t] - w) / abs(w) for t, w in want.items())


def run_peps16_bp(psi16):
    """Phase 23(a): 2-norm BP on phase 16's float64 16x16 state: the BP
    norm and energy and compress_d2bp, each held to quimb_tpu's; the BP
    gauge of the 3D Ising network, held to quimb_tpu's."""
    from quimb_torch.tensor.belief_propagation import D2BP, compress_d2bp

    t_phase = time.perf_counter()
    ref = _slice13_reference("peps16_bp")
    if (ref["L"], ref["D"]) != (PEPS_L, PEPS_D):
        raise AssertionError(f"{SLICE13_REF} holds another PEPS")
    _reset_launches()
    psi = psi16
    ham = quimb_torch.ham_2d_heis(PEPS_L, PEPS_L)
    h2 = ham.get_term(next(iter(ham.terms)))
    base = _fresh_peak()
    bp = D2BP(psi)
    with _counted_syncs() as syncs:
        _, secs = _timed(bp.run)
    mant, expo = bp.contract(strip_exponent=True)
    log10 = expo + math.log10(abs(complex(mant)))
    rel = abs(log10 - ref["log10_norm"]) / abs(ref["log10_norm"])
    print(f"D2BP 16x16 ({len(bp.messages)} messages): {bp.n_iter} "
          f"iterations in {secs:.3f} s (quimb_tpu's {ref['bp_iterations']} "
          f"in {ref['bp_seconds']:.1f} s on the host), "
          f"{secs / bp.n_iter:.3f} s and {len(syncs) / bp.n_iter:.1f} host "
          f"reads an iteration; log10 <psi|psi> {log10!r}, quimb_tpu's "
          f"{ref['log10_norm']!r}, relative {rel:.3e} (bound "
          f"{BP16_TOL:.0e})", flush=True)
    if not rel <= BP16_TOL:
        raise AssertionError("the BP norm misses quimb_tpu's")
    e, esecs = _timed(lambda: sum(bp.local_expectation(h2, where)
                                  for where in ham.terms).real)
    rel = abs(e - ref["bp_energy"]) / abs(ref["bp_energy"])
    e32 = PEPS_QTPU_E_SITE * PEPS_L ** 2
    print(f"  BP energy of {len(ham.terms)} bonds {e!r} ({esecs:.3f} s), "
          f"quimb_tpu's {ref['bp_energy']!r}, relative {rel:.3e} (bound "
          f"{BP16_TOL:.0e}); not gated: {e - e32:+.4e} from the chi="
          f"{PEPS_CHI} boundary energy {e32!r}", flush=True)
    if not rel <= BP16_TOL:
        raise AssertionError("the BP energy misses quimb_tpu's")
    c, csecs = _timed(lambda: compress_d2bp(psi, max_bond=BP16_MAX_BOND,
                                            messages=dict(bp.messages)))
    err = _norms_err(_site_norms(c, ref["compress_norms"]),
                     ref["compress_norms"])
    print(f"  compress_d2bp(max_bond={BP16_MAX_BOND}), warm: {csecs:.3f} s, "
          f"bonds {c.max_bond()}; site norms' largest relative distance "
          f"from quimb_tpu's {err:.3e} (bound {BP16_TOL:.0e})", flush=True)
    if not (err <= BP16_TOL and c.max_bond() == ref["compress_max_bond"]
            and all(t.data.is_cuda for t in c)):
        raise AssertionError("compress_d2bp misses quimb_tpu's")
    # the BP gauge (1-norm BP, D1BP): on this signed state its messages
    # never settle (they still change by ~2 after its 100 iterations, in
    # quimb_tpu as in the port; scripts/slice13_reference.py), so it is
    # held on the positive 3D Ising network of phase 22(a), where they do
    d1 = ref["d1bp"]
    print(f"  not run: psi.gauge_all_belief_propagation(); quimb_tpu's "
          f"D1BP on psi: {d1['iterations']} iterations, converged "
          f"{d1['converged']}, last changes {d1['last_mdiffs']}", flush=True)
    gref = _slice13_reference("ising3d")[f"bp_gauge {ISING_GAUGE_L}"]
    tn = _ising(ISING_GAUGE_L)
    with _counted_syncs() as syncs:
        g, gsecs = _timed(tn.gauge_all_belief_propagation)
    err = _norms_err(_site_norms(g, gref["norms"]), gref["norms"])
    print(f"  gauge_all_belief_propagation of the {ISING_GAUGE_L}^3 Ising "
          f"network: {gsecs:.3f} s (quimb_tpu's host run "
          f"{gref['seconds']:.1f} s), {len(syncs)} host reads; site norms' "
          f"largest relative distance from quimb_tpu's {err:.3e} (bound "
          f"{BP16_TOL:.0e}); peak allocation {_peak_from(base):.4f} GB",
          flush=True)
    if not (err <= BP16_TOL and all(t.data.is_cuda for t in g)):
        raise AssertionError("the BP gauge misses quimb_tpu's")
    warm = D2BP(psi, messages=dict(bp.messages))
    share, top, wall_us, count = _busy_share(warm.iterate)
    print(f"one D2BP iteration under torch.profiler: {wall_us / 1e6:.3f} s "
          f"wall, {count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("D2BP launched a sandwich kernel")
    print(f"16x16 BP phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def run_hyper_bp():
    """Phase 23(b): 1-norm BP on hyper networks, the batched HV1BP and
    the per-message D1BP, each log Z held to quimb_tpu's."""
    from quimb_torch.tensor.belief_propagation import D1BP, HV1BP

    t_phase = time.perf_counter()
    ref = _slice13_reference("hyper")
    if (ref["beta"], ref["h"], ref["ksat"]) != (BETA_C, HYPER_H, KSAT):
        raise AssertionError(f"{SLICE13_REF} holds other hyper networks")
    _reset_launches()

    def ising(L):
        return quimb_torch.HTN3D_classical_ising_partition_function(
            L, L, L, beta=BETA_C, h=HYPER_H)

    runs = (
        (f"hv1bp ising {HYPER_L}", HV1BP, lambda: ising(HYPER_L)),
        (f"hd1bp ising {HYPER_L_D1}", D1BP, lambda: ising(HYPER_L_D1)),
        (f"hv1bp ising {HYPER_L_D1}", HV1BP, lambda: ising(HYPER_L_D1)),
        ("hv1bp ksat", HV1BP, lambda: quimb_torch.HTN_random_ksat(**KSAT)),
    )
    got = {}
    for name, engine, build in runs:
        want = ref[name]
        tn = build()
        if not all(t.data.is_cuda and t.dtype == torch.float64 for t in tn):
            raise AssertionError(f"{name}: the network is not on the card")
        base = _fresh_peak()
        bp = engine(tn)
        with _counted_syncs() as syncs:
            _, secs = _timed(bp.run)
        mant, expo = bp.contract(strip_exponent=True)
        got[name] = expo + math.log10(abs(complex(mant)))
        rel = abs(got[name] - want["log10"]) / abs(want["log10"])
        groups = (f", {len(bp.groups)} shape groups"
                  if engine is HV1BP else "")
        print(f"{name} ({tn.num_tensors} tensors, {tn.num_indices} "
              f"indices{groups}): {bp.n_iter} iterations in {secs:.3f} s "
              f"(quimb_tpu's {want['iterations']} in {want['seconds']:.1f} s "
              f"on the host), {secs / bp.n_iter * 1e3:.2f} ms and "
              f"{len(syncs) / bp.n_iter:.1f} host reads an iteration, peak "
              f"allocation {_peak_from(base):.4f} GB; log10 Z {got[name]!r}, "
              f"quimb_tpu's {want['log10']!r}, relative {rel:.3e} (bound "
              f"{HYPER_TOL:.0e})", flush=True)
        if not rel <= HYPER_TOL:
            raise AssertionError(f"{name} misses quimb_tpu's")
        if engine is HV1BP:
            warm = HV1BP(tn, messages=bp.get_messages())
            share, top, wall_us, count = _busy_share(
                lambda: [warm.iterate() for _ in range(3)])
            print(f"  three iterations under torch.profiler: "
                  f"{wall_us / 1e6:.4f} s wall, {count} device activities, "
                  f"busy share "
                  + ("not measured" if share is None else f"{share:.4f}"),
                  flush=True)
            for kname, us in top[:3]:
                print(f"    {us / 1e3:.3f} ms  {kname[:100]}", flush=True)
    a, b = got[f"hd1bp ising {HYPER_L_D1}"], got[f"hv1bp ising {HYPER_L_D1}"]
    rel = abs(a - b) / abs(b)
    print(f"D1BP against HV1BP at {HYPER_L_D1}^3: relative {rel:.3e} (bound "
          f"{HYPER_ENGINES_TOL:.0e})", flush=True)
    if not rel <= HYPER_ENGINES_TOL:
        raise AssertionError("the two BP engines reach different points")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("hyper BP launched a sandwich kernel")
    print(f"hyper BP phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phases 24-25: optimisation, fitting and the spectral estimates --------

# quimb_tpu's float64 values of phases 24-25 and the CPU rehearsals of
# 24(a) and 25, from ``python scripts/slice14_reference.py`` on a CPU
SLICE14_REF = "scripts/slice14_reference.json"
# 24(a): the methods beside dm, and the bound on each infidelity: ten
# times dm's on this state plus the method's own rehearsal infidelity
# (quimb_tpu, L=32, chi=64) scaled by L / 32
COMPRESS_1D_METHODS = ("fit", "src-oversample", "projector", "bidm")
COMPRESS_1D_FACTOR = 10
# the dispatcher's default cutoff: at cutoff 0 bidm keeps rounding-level
# singular values and divides by their square roots, which on the card
# spoiled its result (infidelity 0.91; 1e-12 on a CPU at L=64, chi=128)
COMPRESS_1D_CUTOFF = 1e-10
COMPRESS_1D_SEED = 7
# 24(b): the start state, the iterations, and the bound on each loss
# relative to quimb_tpu's (the port's CPU run reads 1e-15 from it at L=8)
OPT_SEED, OPT_LBFGS_ITS, OPT_ADAM_STEPS, OPT_ADAM_LR = 42, 3, 3, 0.01
OPT_REL_TOL = 1e-8
# 24(c): tau, the steps' time budget (with the energy's 12-18 s, the
# sub-phase near 25 s) and the most steps quimb_tpu ran
CLUSTER_TAU, CLUSTER_SECONDS, CLUSTER_MAX_STEPS = 0.3, 10.0, 4
CLUSTER_E_TOL = 1e-8
# 25: the block, the SLQ settings (one wave of 1024 probes: the standard
# error at stopping then sits well inside tol x scale), and the rsvd
SPEC_BLOCK, SLQ_SEED, SLQ_TOL, SLQ_R_MIN = 10, 7, 0.05, 1024
RSVD_K, RSVD_P, RSVD_FACTOR = 16, 8, 10


def _slice14_reference(part):
    return json.loads(Path(SLICE14_REF).read_text())[part]


def _chain_lpr(tn, psi):
    """The (l, p, r) arrays of a one-tensor-per-site chain with ``psi``'s
    site tags and indices, the ends padded with size-1 bonds."""
    ts = [tn[psi.site_tag(i)] for i in range(psi.L)]
    out = []
    for i, t in enumerate(ts):
        lb = [ix for ix in t.inds if i > 0 and ix in ts[i - 1].inds]
        rb = [ix for ix in t.inds if i < psi.L - 1 and ix in ts[i + 1].inds]
        a = t.transpose(*lb, psi.site_ind(i), *rb).data
        out.append(a.reshape(max(1, math.prod(a.shape[:len(lb)])),
                             a.shape[len(lb)], -1))
    return out


def _card_overlap(As, Bs, Ws):
    """<B|W|A> of uniform (l, p, r) arrays and (wl, wr, u, d) MPO arrays
    (``None``: the identity), by one site sweep on the card."""
    env = torch.ones((1, 1, 1), dtype=torch.float64, device="cuda")
    for i, (A, B) in enumerate(zip(As, Bs)):
        T = torch.einsum("awb,bpr->awpr", env, A)
        if Ws is not None:
            T = torch.einsum("awpr,wxqp->axqr", T, Ws[i])
        env = torch.einsum("awqr,aqs->swr", T, B.conj())
    return float(env.reshape(()))


def _card_h2(As, Ws):
    """<H psi|H psi> by one site sweep on the card."""
    env = torch.ones((1, 1, 1, 1), dtype=torch.float64, device="cuda")
    for A, W in zip(As, Ws):
        T = torch.einsum("avwb,bpr->avwpr", env, A)
        T = torch.einsum("avwpr,wyqp->avyqr", T, W)
        T = torch.einsum("avyqr,vxcq->axycr", T, W.conj())
        env = torch.einsum("axycr,acs->sxyr", T, A.conj())
    return float(env.reshape(()))


def run_compress_1d(dmrg):
    """Phase 24(a): H|psi> of the north-star state compressed back to 256
    by each 1D method, and by compress_all_1d."""
    from quimb_torch.tensor.tn1d import compress as tcomp

    t_phase = time.perf_counter()
    ref = _slice14_reference("compress")
    if ref.get("cutoff") != COMPRESS_1D_CUTOFF:
        raise AssertionError(f"{SLICE14_REF} holds another compression "
                             f"rehearsal")
    _reset_launches()
    psi = dmrg.state
    H = quimb_torch.MPO_ham_heis(L, dtype=torch.float64, device="cuda")
    As, Ws = _arrays(psi), _arrays(H)
    hh = _card_h2(As, Ws)
    site_tags = [psi.site_tag(i) for i in range(L)]

    def infidelity(out):
        Bs = _chain_lpr(out, psi)
        if not all(b.is_cuda and b.shape[2] <= CHI for b in Bs):
            raise AssertionError("a compressed site left the card or its "
                                 "bond exceeds 256")
        return 1 - _card_overlap(As, Bs, Ws) ** 2 / (
            _card_overlap(Bs, Bs, None) * hh)

    results = {}
    for method in ("dm", *COMPRESS_1D_METHODS):
        kw = {"seed": COMPRESS_1D_SEED} if method.startswith("src") else {}
        base = _fresh_peak()
        tn = tcomp._lazy_mpo_mps_tn(H, psi)
        out, secs = _timed(lambda: tcomp.tensor_network_1d_compress(
            tn, max_bond=CHI, cutoff=COMPRESS_1D_CUTOFF, method=method,
            site_tags=site_tags, **kw))
        results[method] = (infidelity(out), secs, _peak_from(base))
        del tn, out
    base = _fresh_peak()
    Hpsi = H.apply(psi)
    out, secs = _timed(lambda: Hpsi.compress_all_1d(
        max_bond=CHI, cutoff=COMPRESS_1D_CUTOFF))
    results["compress_all_1d"] = (infidelity(out), secs, _peak_from(base))
    del Hpsi, out
    dm = results["dm"][0]
    failed = []
    for method, (inf, secs, peak) in results.items():
        rehearsal = ref["quimb_tpu"][
            "dm" if method == "compress_all_1d" else method]
        bound = COMPRESS_1D_FACTOR * (dm + L / ref["L"] * rehearsal)
        print(f"compress H|psi> (bond {5 * CHI}) to {CHI} by {method}: "
              f"{secs:.3f} s, peak allocation {peak:.3f} GB, infidelity "
              f"{inf:.6e} (dm's {dm:.6e}; quimb_tpu's rehearsal at L="
              f"{ref['L']}, chi={ref['chi']}: {rehearsal:.3e}, the port's "
              f"{ref['quimb_torch'].get(method, ref['quimb_torch']['dm']):.3e}"
              f"; bound {bound:.3e})", flush=True)
        if not (math.isfinite(inf) and inf <= bound):
            failed.append(method)
    if failed:
        raise AssertionError(f"the compressions {failed} miss their bounds")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the 1D compressions launched a sandwich "
                             "kernel")
    torch.cuda.empty_cache()
    print(f"1D compression phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def opt_start_arrays(L, chi, seed, phys_dim=2):
    """scripts/slice14_reference.py's start arrays: (l, r, p) standard
    normal draws of ``default_rng(seed)`` in the shapes of
    ``MPS_rand_state``, each scaled so that the left norm environment
    after its site has unit trace (edges padded)."""
    rng = np.random.default_rng(seed)
    arrays, env = [], np.ones((1, 1))
    for i in range(L):
        chil = min(chi, phys_dim**i, phys_dim**(L - i))
        chir = min(chi, phys_dim**(i + 1), phys_dim**(L - i - 1))
        A = rng.standard_normal((chil, chir, phys_dim))
        new = np.tensordot(np.tensordot(env, A, (0, 0)), A, ((0, 2), (0, 2)))
        A = A / np.sqrt(np.trace(new))
        env = new / np.trace(new)
        arrays.append(A)
    return arrays


def rayleigh_quotient(As, Ws):
    """<psi|H|psi> / <psi|psi> of (l, r, p) arrays and (wl, wr, u, d) MPO
    arrays (edges padded), site by site (chi^3), in the order of
    scripts/slice14_reference.py: both environments divided at each site
    by the norm environment's Frobenius norm (Adam grows the parameters;
    past <psi|psi> of about 1e154 JAX's gradient of the plain quotient
    overflowed to 0)."""
    env = torch.ones((1, 1, 1), dtype=As[0].dtype, device=As[0].device)
    nrm = torch.ones((1, 1), dtype=As[0].dtype, device=As[0].device)
    for A, W in zip(As, Ws):
        T = torch.einsum("awb,brp->awrp", env, A)
        T = torch.einsum("awrp,wxqp->axrq", T, W)
        env = torch.einsum("axrq,asq->sxr", T, A.conj())
        n = torch.einsum("ab,brp->arp", nrm, A)
        nrm = torch.einsum("arp,asp->sr", n, A.conj())
        c = torch.linalg.norm(nrm)
        env, nrm = env / c, nrm / c
    return (env.reshape(()) / nrm.reshape(())).real


def run_tnoptimizer():
    """Phase 24(b): TNOptimizer at the north star, L-BFGS-B then Adam,
    against quimb_tpu's losses from the same arrays."""
    from quimb_torch.tensor import optimize as topt

    t_phase = time.perf_counter()
    ref = _slice14_reference("optimizer")
    if (ref["L"], ref["chi"], ref["seed"]) != (L, CHI, OPT_SEED):
        raise AssertionError(f"{SLICE14_REF} holds another optimizer run")
    _reset_launches()
    arrays = opt_start_arrays(L, CHI, OPT_SEED)
    arrays = [arrays[0][0]] + arrays[1:-1] + [arrays[-1][:, 0]]
    psi = quimb_torch.MatrixProductState(
        [torch.as_tensor(a, device="cuda") for a in arrays], shape="lrp")
    H = quimb_torch.MPO_ham_heis(L, dtype=torch.float64, device="cuda")
    Ws = [t.data for t in H]
    Ws = [Ws[0][None]] + Ws[1:-1] + [Ws[-1][:, None]]

    def loss(psi):
        As = [psi[psi.site_tag(i)].data for i in range(psi.L)]
        return rayleigh_quotient([As[0][None]] + As[1:-1]
                                 + [As[-1][:, None]], Ws)

    copies = {"pack": 0, "unpack": 0}
    orig = {k: getattr(topt.Vectorizer, k) for k in copies}

    def counting(name):
        def fn(self, *args):
            copies[name] += 1
            return orig[name](self, *args)
        return fn

    for name in copies:
        setattr(topt.Vectorizer, name, counting(name))
    failed = []
    try:
        for name, n, kw in (("lbfgsb", OPT_LBFGS_ITS, {}),
                            ("adam", OPT_ADAM_STEPS,
                             dict(optimizer="adam",
                                  learning_rate=OPT_ADAM_LR))):
            for k in copies:
                copies[k] = 0
            opt = quimb_torch.TNOptimizer(psi, loss, progbar=False, **kw)
            tn, secs = _timed(lambda: opt.optimize(n))
            got = np.array(opt.losses)
            want = np.array(ref[name]["losses"])
            rel = (np.max(np.abs(got - want) / np.abs(want))
                   if got.shape == want.shape else float("inf"))
            on_card = (all(p.is_cuda for p in opt.params.values())
                       and all(t.data.is_cuda for t in tn))
            print(f"TNOptimizer {name} at L={L}, chi={CHI} ({opt.d} real "
                  f"parameters): {n} iterations, {opt.nevals} loss "
                  f"evaluations in {secs:.3f} s ({secs / opt.nevals:.3f} s "
                  f"each; quimb_tpu's host run {ref[name]['seconds']:.1f} "
                  f"s); losses {got[0]!r} -> {got[-1]!r}, largest distance "
                  f"from quimb_tpu's {rel:.3e} (bound {OPT_REL_TOL:.0e}); "
                  f"host vectors: {copies['pack']} packed, "
                  f"{copies['unpack']} unpacked, "
                  f"{8 * opt.d / 1e6:.1f} MB each", flush=True)
            if not (rel <= OPT_REL_TOL and on_card):
                failed.append(name)
            if name == "lbfgsb" and not got[-1] < got[0]:
                failed.append("lbfgsb does not fall")
            del opt, tn
    finally:
        for name, fn in orig.items():
            setattr(topt.Vectorizer, name, fn)
    if failed:
        raise AssertionError(f"TNOptimizer: {failed}")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("TNOptimizer launched a sandwich kernel")
    torch.cuda.empty_cache()
    print(f"TNOptimizer phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def run_cluster_update():
    """Phase 24(c): ClusterUpdateGen on the kagome model, against
    quimb_tpu's energy after as many steps."""
    from quimb_torch.experimental import ClusterUpdateGen, cluster_update

    t_phase = time.perf_counter()
    ref = _slice14_reference("cluster")
    if (ref["L"], ref["D"], ref["tau"], ref["gauge_iterations"]) != (
            KAGOME_L, KAGOME_D, CLUSTER_TAU, KAGOME_GAUGE_ITERATIONS):
        raise AssertionError(f"{SLICE14_REF} holds another cluster run")
    _reset_launches()
    edges = quimb_torch.edges_2d_kagome(KAGOME_L, KAGOME_L)
    rng = np.random.default_rng(42)
    psi0 = quimb_torch.TN_from_edges_and_fill_fn(
        lambda shape: rng.standard_normal(shape), edges, KAGOME_D,
        phys_dim=2)
    ham = quimb_torch.ham_gen_heis(edges)
    nb = len(ham.terms)
    cluster_update.HOST_READS.clear()
    su = ClusterUpdateGen(psi0, ham, D=KAGOME_D, cluster_distance=1,
                          compute_energy_final=False)
    secs = []
    while len(secs) < min(CLUSTER_MAX_STEPS, len(ref["energy_per_site"])):
        _, t = _timed(lambda: su.evolve(1, tau=CLUSTER_TAU))
        secs.append(t)
        if sum(secs) + t > CLUSTER_SECONDS:
            break
    steps = len(secs)
    reads = dict(cluster_update.HOST_READS)
    gauges = {}
    tn, gsecs = _timed(lambda: su.get_state().gauge_all_simple(
        max_iterations=KAGOME_GAUGE_ITERATIONS, gauges=gauges))
    with ThreadPoolExecutor(KAGOME_THREADS) as ex:
        e, csecs = _timed(lambda: tn.compute_local_expectation(
            ham.terms, method="cluster", gauges=gauges, executor=ex))
    e_site = float(np.real(e)) / psi0.nsites
    want = ref["energy_per_site"][steps - 1]
    rel = abs(e_site - want) / abs(want)
    print(f"ClusterUpdateGen kagome {KAGOME_L}x{KAGOME_L} ({psi0.nsites} "
          f"sites, {nb} bonds), D={KAGOME_D}, tau {CLUSTER_TAU}: {steps} "
          f"steps in {sum(secs):.3f} s ({', '.join(f'{t:.2f}' for t in secs)}"
          f"; quimb_tpu's host run {sum(ref['step_seconds'][:steps]):.1f} "
          f"s), {steps * nb / sum(secs):.1f} gates a second; host reads a "
          f"gate: {reads.get('site norm', 0) / (steps * nb):.2f} site norms, "
          f"{reads.get('als cost', 0) / (steps * nb):.2f} ALS costs; energy "
          f"({gsecs:.3f} + {csecs:.3f} s) E/site {e_site!r}, quimb_tpu's "
          f"{want!r}, relative {rel:.3e} (bound {CLUSTER_E_TOL:.0e})",
          flush=True)
    if not all(t.data.is_cuda for t in su.state):
        raise AssertionError("ClusterUpdateGen left the card")
    if not rel <= CLUSTER_E_TOL:
        raise AssertionError("the cluster-update energy misses quimb_tpu's")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("ClusterUpdateGen launched a sandwich kernel")
    print(f"cluster update phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def run_spectral(dmrg):
    """Phase 25: SLQ of a 10-site block's reduced density matrix as a
    lazy network, against its exact spectrum, and rsvd of it."""
    t_phase = time.perf_counter()
    ref = _slice14_reference("spectral")
    _reset_launches()
    start = L // 2 - SPEC_BLOCK // 2
    block = range(start, start + SPEC_BLOCK)
    psi = dmrg.state.copy()
    psi.canonize((block[0], block[-1]))
    ket = quimb_torch.TensorNetwork([psi[psi.site_tag(i)].copy()
                                     for i in block])
    bra = ket.conj().reindex({psi.site_ind(i): f"b{i}" for i in block})
    bra.mangle_inner_()
    A = quimb_torch.TNLinearOperator(
        ket & bra, [psi.site_ind(i) for i in block],
        [f"b{i}" for i in block])
    rho, dsecs = _timed(A.to_dense)
    _on_card("rho_A", rho, torch.float64)
    w = torch.clamp(torch.linalg.eigvalsh(rho), min=0)
    exact = float(torch.sum(torch.where(
        w > 0, w * torch.log2(torch.where(w > 0, w, 1.0)), 0.0)))
    info = {}
    est, secs = _timed(lambda: quimb_torch.
                       tensor_network_approx_spectral_function(
                           A, quimb_torch.xlogx, pos=True, seed=SLQ_SEED,
                           tol=SLQ_TOL,
                           R_min=SLQ_R_MIN, info=info))
    gap = abs(est - exact)
    print(f"SLQ of rho_A ({SPEC_BLOCK} sites, {A.shape[0]} x {A.shape[1]}, "
          f"{ket.num_tensors * 2} tensors): Tr rho log2 rho {est!r} in "
          f"{secs:.3f} s ({info['R']} probes, K={info['K']} Lanczos steps, "
          f"standard error {info['error']:.3e}); exact {exact!r} (dense "
          f"rho {dsecs:.3f} s, trace {float(torch.trace(rho))!r}); "
          f"distance {gap:.3e}, bound tol x scale "
          f"{SLQ_TOL * info['scale']:.3e}; S = {-est!r} bits", flush=True)
    if not gap <= SLQ_TOL * info["scale"]:
        raise AssertionError("the SLQ entropy misses the exact one")
    (U, s, VH), rsecs = _timed(lambda: quimb_torch.rsvd(
        rho, RSVD_K, p=RSVD_P, seed=SLQ_SEED))
    sv = torch.linalg.svdvals(rho)
    rel = float(torch.max(torch.abs(s - sv[:RSVD_K])) / sv[0])
    bound = max(RSVD_FACTOR * ref["rsvd_max_rel"], 1e-13)
    print(f"rsvd(rho, {RSVD_K}, p={RSVD_P}): {rsecs:.3f} s; largest "
          f"distance of its values from torch.linalg.svdvals {rel:.3e} of "
          f"the largest (quimb_tpu's on the rehearsal's rho "
          f"{ref['rsvd_max_rel']:.3e}; bound {bound:.3e})", flush=True)
    if not (s.is_cuda and rel <= bound):
        raise AssertionError("rsvd misses the singular values")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the spectral estimates launched a sandwich "
                             "kernel")
    print(f"spectral phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 26: exact diagonalisation in a symmetry sector --------------------

# quimb_tpu's values of phases 26 and 27, from scripts/slice15_reference.py
SLICE15_REF = "scripts/slice15_reference.json"
# the exact ground energy of the Heisenberg antiferromagnet on the 4 x 4
# torus (S^z = 0), which quimb_tpu's sector matrix and scipy's eigsh
# reproduce; the bounds on the relative energy, on the Ritz residual
# ||H psi - E psi|| of the normalised state, and on the relative distance
# of the matrix-free matvec from the ELL one (float64 rounding over 144
# terms a row)
ED_E_4X4 = -11.228483208428864
ED_E_TOL, ED_RES_TOL, ED_MV_TOL = 1e-10, 1e-6, 1e-12
# the ground state's Lanczos stopping rule (the Ritz value's change
# between restarts, relative): at groundenergy's default 1e-10 the state
# can stop a few 1e-6 from the eigenvector
ED_STATE_TOL = 1e-13
# the matvecs profiled together for the launch count
ED_PROFILED = 5


def _slice15_reference(part):
    return json.loads(Path(SLICE15_REF).read_text())[part]


def _torus_builder(Lx, Ly):
    """The Heisenberg antiferromagnet on the Lx x Ly torus in the U1
    sector of half filling, through the entry points."""
    from quimb_torch.operator import HilbertSpace, heisenberg_from_edges

    edges = quimb_torch.edges_2d_square(Lx, Ly, cyclic=True)
    sites = sorted({s for e in edges for s in e})
    hs = HilbertSpace(sites, symmetry="U1", sector=len(sites) // 2)
    return heisenberg_from_edges(edges, hilbert_space=hs)


def _coupled_ham_bytes(op):
    """The device bytes of a CoupledHam: configurations, diagonal, rank
    and amplitude tables."""
    ts = [op.configs, op.diag] + [t for g in op.groups for t in g[:3]]
    if op._segments:
        ts += [op._pop] + [w[2] for _, ws in op._segments for w in ws]
    return sum(t.numel() * t.element_size() for t in ts)


def run_sector_ed():
    """Phase 26: the Heisenberg antiferromagnet on the 4 x 4 and 4 x 6 tori
    in the U1 sector of half filling by the matrix-free CoupledHam."""
    from quimb_torch.operator import CoupledHam

    t_phase = time.perf_counter()
    ref = _slice15_reference("ed")
    _reset_launches()
    b = _torus_builder(4, 4)
    op = b.build_coupled_ham(dtype="float64")
    if not (op.configs.is_cuda and op.configs.dtype == torch.int64):
        raise AssertionError("the 4 x 4 configurations are not int64 words "
                             "on the card")
    e, secs = _timed(lambda: quimb_torch.groundenergy(op))
    _on_card("4 x 4 groundenergy", e, torch.float64)
    rel = abs(float(e) - ED_E_4X4) / abs(ED_E_4X4)
    rel_q = abs(float(e) - ref["4x4"]["energy"]) / abs(ED_E_4X4)
    ell = b.build_sparse_ham(dtype=torch.float64)
    _on_card("4 x 4 SparseHam values", ell.vals, torch.float64)
    x = _cuda(np.random.default_rng(SEED).standard_normal(op.shape[0]),
              torch.float64)
    want = ell.matvec(x)
    mv_rel = (torch.linalg.norm(op.matvec(x) - want)
              / torch.linalg.norm(want)).item()
    print(f"sector ED 4 x 4 torus: D={op.shape[0]}, groundenergy "
          f"{float(e)!r} in {secs:.3f} s; against the exact "
          f"{ED_E_4X4!r} relative {rel:.3e}, against quimb_tpu's "
          f"{ref['4x4']['energy']!r} {rel_q:.3e} (bound {ED_E_TOL:.0e}); "
          f"CoupledHam against the ELL SparseHam relative {mv_rel:.3e} "
          f"(bound {ED_MV_TOL:.0e})", flush=True)
    if not (rel <= ED_E_TOL and rel_q <= ED_E_TOL and mv_rel <= ED_MV_TOL):
        raise AssertionError("the 4 x 4 torus misses its energy or matvec")
    del op, ell, x, want

    base = _fresh_peak()
    b, bsecs = _timed(lambda: _torus_builder(4, 6))
    op, osecs = _timed(lambda: b.build_coupled_ham(dtype="float64"))
    D = op.shape[0]
    r = ref["4x6"]
    if D != r["D"] or op.configs.dtype != torch.int64:
        raise AssertionError(f"the 4 x 6 sector has {D} configurations")
    print(f"sector ED 4 x 6 torus: D={D}, terms per arity "
          f"{op.nterms_by_arity}, {op.ngroups} off-diagonal (sites, flip) "
          f"groups; builder {bsecs:.3f} s, CoupledHam {osecs:.3f} s "
          f"(configurations on the host, once), "
          f"{_coupled_ham_bytes(op) / 1e6:.1f} MB on the card; quimb_tpu's "
          f"sector matrix: {r['nnz']} nonzeros, built in "
          f"{r['build_s']:.1f} s, scipy eigsh {r['solve_s']:.1f} s, peak "
          f"{r['peak_rss_gb']:.2f} GB on the host (CPU)", flush=True)
    with _calls(CoupledHam, "matvec") as count:
        e, esecs = _timed(lambda: quimb_torch.groundenergy(op))
        n_e = count[0]
        psi, psecs = _timed(lambda: quimb_torch.groundstate(
            op, tol=ED_STATE_TOL))
        n_psi = count[0] - n_e
    _on_card("4 x 6 groundenergy", e, torch.float64)
    _on_card("4 x 6 groundstate", psi, torch.float64)
    v = psi[:, 0] / torch.linalg.norm(psi[:, 0])
    hv = op.matvec(v)
    ritz = torch.dot(v, hv)
    res = torch.linalg.norm(hv - ritz * v).item()
    rel = abs(float(e) - r["energy"]) / abs(r["energy"])
    rel_ritz = abs(float(ritz) - r["energy"]) / abs(r["energy"])
    print(f"4 x 6 groundenergy {float(e)!r}: {n_e} matvecs, {esecs:.3f} s; "
          f"groundstate (tol {ED_STATE_TOL:.0e}) {n_psi} matvecs, "
          f"{psecs:.3f} s, Rayleigh quotient {float(ritz)!r}; against "
          f"quimb_tpu's {r['energy']!r}: relative {rel:.3e} and "
          f"{rel_ritz:.3e} (bound {ED_E_TOL:.0e}); Ritz residual {res:.3e} "
          f"(bound {ED_RES_TOL:.0e}); peak {_peak_from(base):.3f} GB",
          flush=True)
    if not (rel <= ED_E_TOL and rel_ritz <= ED_E_TOL and res <= ED_RES_TOL):
        raise AssertionError("the 4 x 6 torus misses its energy or residual")

    x = _cuda(np.random.default_rng(SEED).standard_normal(D), torch.float64)
    times = []
    for _ in range(5):
        times.append(_event_ms(op.matvec, (x,), reps=1))
    ms = statistics.median(times)
    # five matvecs under one profile: a single one read 23 activities in
    # one run, where its kernels' times showed half of them missing
    share, top, wall_us, count = _busy_share(
        lambda: [op.matvec(x) for _ in range(ED_PROFILED)])
    launches = count / ED_PROFILED
    bound_ms = 24 * D / PEAK_BYTES * 1e3
    print(f"CoupledHam matvec (D={D}, float64): {ms:.3f} ms (median of 5 "
          f"CUDA-event timings {[round(t, 3) for t in times]}); "
          f"{launches:g} device launches a matvec ({count} in "
          f"{ED_PROFILED} under torch.profiler); bound: configs, x "
          f"and y once, 24 B x D over {PEAK_BYTES / 1e12:.2f} TB/s = "
          f"{bound_ms:.4f} ms, share {bound_ms / ms:.4f}", flush=True)
    for name, us in top:
        print(f"  {us / 1e3 / ED_PROFILED:.3f} ms a matvec  {name[:100]}",
              flush=True)
    from quimb_torch.linalg.lanczos import eigh_lanczos

    share, top, wall_us, count = _busy_share(
        lambda: eigh_lanczos(op, x, ncv=20, restarts=1))
    print(f"one Lanczos restart (20 matvecs) under torch.profiler: "
          f"{wall_us / 1e3:.3f} ms wall, {count} device activities, busy "
          f"share " + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the sector ED launched a sandwich kernel")
    del op, psi, v, hv, x, b
    torch.cuda.empty_cache()
    print(f"sector ED phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 27: the dense matrix half on the exact 20-qubit state -------------

MH_ENT_SITES = tuple(range(10))
MH_MUTINF_SITES = (tuple(range(0, 5)), tuple(range(10, 15)))
MH_LOGNEG_SITES = (tuple(range(4, 10)), tuple(range(10, 16)))
MH_PAIR = (9, 10)
# the ground state to machine precision: Lanczos restarts until the last
# one, so the quantities sit within rounding of quimb_tpu's (held to 1e-10
# absolute); the Lindblad and solve density operators within 1e-8
# relative; the Lindblad chain, its dephasing rate and time
MH_RESTARTS, MH_CALC_TOL, MH_RHO_TOL = 15, 1e-10, 1e-8
MH_LINDBLAD_N, MH_GAMMA, MH_T = 10, 0.1, 1.0
# the integrated <Z_0> against REFBASE and the expm path: quimb_tpu's RK45
# keeps each step's error estimate under atol + rtol |psi| = 1.01e-8 (2-norm),
# and its own run of this protocol on a CPU reads 1.66e-9 from REFBASE at
# t = 1 (scripts/slice15_reference.json), past phase 11's 1e-9 for the
# Krylov path; the port is held to quimb_tpu's steps at MH_CALC_TOL
MH_Z_TOL = 1e-8


def _z_all(rho, n):
    """<Z_i> of every site of a density operator on the card."""
    p = torch.real(torch.diagonal(rho))
    idx = torch.arange(2**n, device=rho.device)
    return [float(torch.sum(p * (1 - 2 * ((idx >> (n - 1 - i)) & 1))))
            for i in range(n)]


def _rel_list(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def run_matrix_half(expm_z0):
    """Phase 27: calc's quantities of phase 11's N=20 ground state, then
    Evolution by RK45 over phase 11's protocol; then a 10-site density
    operator under the Lindblad equation and by solve."""
    from quimb_torch import calc
    from quimb_torch.core import dop, ikron, ptr
    from quimb_torch.gen.operators import pauli

    t_phase = time.perf_counter()
    ref = _slice15_reference("dense")
    _reset_launches()
    base = _fresh_peak()
    n = EXACT_N
    dims = (2,) * n
    H = quimb_torch.ham_heis(n, sparse=True)
    psi, secs = _timed(lambda: quimb_torch.groundstate(
        H, tol=0.0, restarts=MH_RESTARTS))
    _on_card("N=20 ground state", psi, torch.float64)
    op = quimb_torch.device_operator(H)
    e = float(torch.dot(psi[:, 0], op @ psi[:, 0]))
    print(f"matrix half: N={n} ground state by {MH_RESTARTS} Lanczos "
          f"restarts in {secs:.3f} s, energy {e!r} (quimb_tpu's eigsh "
          f"{ref['energy']!r})", flush=True)
    rho2 = ptr(psi, dims, MH_PAIR)
    got = {}
    t0 = time.perf_counter()
    got["entropy_subsys"] = calc.entropy_subsys(psi, dims, MH_ENT_SITES)
    got["mutinf_subsys"] = calc.mutinf_subsys(psi, dims, *MH_MUTINF_SITES)
    got["logneg_subsys"], lsecs = _timed(lambda: calc.logneg_subsys(
        psi, dims, *MH_LOGNEG_SITES))
    got["schmidt_gap"] = calc.schmidt_gap(psi, dims, MH_ENT_SITES)
    got["concurrence"] = calc.concurrence(rho2)
    got["pauli_correlations"] = list(calc.pauli_correlations(rho2, sysa=0,
                                                             sysb=1))
    torch.cuda.synchronize()
    csecs = time.perf_counter() - t0
    worst = 0.0
    for k, v in got.items():
        d = float(np.max(np.abs(np.asarray(v) - np.asarray(ref[k]))))
        worst = max(worst, d)
        print(f"  {k}: {v!r} (quimb_tpu {ref[k]!r}, distance {d:.3e})",
              flush=True)
    print(f"calc on the N={n} state: {csecs:.3f} s (logneg_subsys of a "
          f"4096 x 4096 rho_AB {lsecs:.3f} s); largest distance from "
          f"quimb_tpu's {worst:.3e} (bound {MH_CALC_TOL:.0e})", flush=True)
    if not worst <= MH_CALC_TOL:
        raise AssertionError("calc misses quimb_tpu's values")
    del psi, rho2, op

    z_refbase = _exact_reference()[1]
    p0 = quimb_torch.computational_state("01" * (n // 2))
    bit0 = (torch.arange(2**n, device=p0.device) >> (n - 1)) & 1
    zdiag = (1 - 2 * bit0).to(torch.float64)
    evo = quimb_torch.Evolution(p0, H, method="integrate")
    zs, t0 = [], time.perf_counter()
    for k in range(1, EXACT_NT + 1):
        evo.update_to(EXACT_T * k / EXACT_NT)
        p = torch.abs(evo.pt.reshape(-1)) ** 2
        zs.append(float(torch.sum(p * zdiag) / torch.sum(p)))
    torch.cuda.synchronize()
    isecs = time.perf_counter() - t0
    _on_card("integrated state", evo.pt, torch.complex128)
    d_ref = float(np.max(np.abs(np.asarray(zs) - z_refbase)))
    d_expm = float(np.max(np.abs(np.asarray(zs) - np.asarray(expm_z0))))
    d_q = float(np.max(np.abs(np.asarray(zs) - np.asarray(
        ref["integrate_z0"]))))
    print(f"Evolution(method='integrate') N={n} to t={EXACT_T}: <Z_0> {zs}; "
          f"{evo.steps} RK45 steps ({evo.rejected} rejected), "
          f"{evo.host_reads} host reads, {isecs:.3f} s; against REFBASE "
          f"{d_ref:.3e}, the expm path {d_expm:.3e} (bound "
          f"{MH_Z_TOL:.0e}), quimb_tpu's RK45 {d_q:.3e} (bound "
          f"{MH_CALC_TOL:.0e})", flush=True)
    if not (d_ref <= MH_Z_TOL and d_expm <= MH_Z_TOL
            and d_q <= MH_CALC_TOL):
        raise AssertionError("the integrated <Z_0> misses its references")
    del evo, p0, zdiag, bit0

    ref = _slice15_reference("lindblad")
    n = MH_LINDBLAD_N
    dims = (2,) * n
    Hd = quimb_torch.ham_heis(n)
    Z = pauli("Z")
    ls = [ikron(Z, dims, i) for i in range(n)]
    p0 = dop(quimb_torch.computational_state("01" * (n // 2)))
    lind = quimb_torch.Evolution(p0, (Hd, ls, MH_GAMMA), method="integrate")
    _, lsecs = _timed(lambda: lind.update_to(MH_T))
    _on_card("Lindblad rho", lind.pt, torch.complex128)
    z, pur = _z_all(lind.pt, n), float(torch.real(torch.sum(
        lind.pt * lind.pt.T)))
    dz, dp = _rel_list(z, ref["lindblad_z"]), abs(
        pur - ref["lindblad_purity"]) / ref["lindblad_purity"]
    print(f"Lindblad, N={n} ({2**n} x {2**n} rho), gamma={MH_GAMMA} dephasing "
          f"on every site, to t={MH_T}: {lind.steps} RK45 steps "
          f"({lind.rejected} rejected), {lind.host_reads} host reads, "
          f"{lsecs:.3f} s (quimb_tpu's CPU run {ref['lindblad_s']:.1f} s, "
          f"host); <Z_0> {z[0]!r}, purity {pur!r}; relative to quimb_tpu's "
          f"<Z_i> {dz:.3e}, purity {dp:.3e} (bound {MH_RHO_TOL:.0e})",
          flush=True)
    solve = quimb_torch.Evolution(p0, Hd, method="solve")
    _, ssecs = _timed(lambda: solve.update_to(MH_T))
    zs_, pur_s = _z_all(solve.pt, n), float(torch.real(torch.sum(
        solve.pt * solve.pt.T)))
    diag = torch.real(torch.diagonal(solve.pt)).cpu().numpy()
    ds = max(_rel_list(zs_, ref["solve_z"]), _rel_list(
        diag, ref["solve_diag"]), abs(pur_s - ref["solve_purity"]))
    print(f"solve, N={n} density operator to t={MH_T}: {ssecs:.3f} s; "
          f"<Z_i>, diagonal and purity relative to quimb_tpu's {ds:.3e} "
          f"(bound {MH_RHO_TOL:.0e}); peak {_peak_from(base):.3f} GB",
          flush=True)
    if not (dz <= MH_RHO_TOL and dp <= MH_RHO_TOL and ds <= MH_RHO_TOL):
        raise AssertionError("the density operators miss quimb_tpu's")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("the matrix half launched a sandwich kernel")
    del lind, solve, Hd, ls, p0
    torch.cuda.empty_cache()
    print(f"matrix half phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 28: CircuitDense at 28 qubits --------------------------------------

CDENSE_N, CDENSE_DEPTH, CDENSE_SEED, CDENSE_SAMPLES = 28, 8, 7, 4
# the dense amplitudes against the lazy network's (both complex128: the
# dense state passes 108 gates, each a rounding of 2**28 entries); the
# norm of the state
CDENSE_AMP_TOL, CDENSE_NORM_TOL = 1e-10, 1e-12
# xeb reads one number and sends the strings' indices: a few bytes, far
# below the 2 GiB of |psi|^2
CDENSE_XEB_BYTES = 4096


def run_circuit_dense():
    """Phase 28: the gates of circ_ansatz_1D_brickwork(28, 8, seed=7)
    applied eagerly to a 2**28 complex128 state, held to the lazy
    Circuit."""
    t_phase = time.perf_counter()
    _reset_launches()
    base = _fresh_peak()
    lazy = quimb_torch.circ_ansatz_1D_brickwork(CDENSE_N, CDENSE_DEPTH,
                                                seed=CDENSE_SEED)
    dense, isecs = _timed(lambda: quimb_torch.CircuitDense(CDENSE_N))
    _, gsecs = _timed(lambda: dense.apply_gates(lazy.gates))
    ngates = len(lazy.gates)
    _on_card("CircuitDense state", dense.psi, torch.complex128)
    nrm = float(torch.linalg.norm(dense.psi))
    samples, ssecs = _timed(lambda: list(dense.sample(CDENSE_SAMPLES,
                                                      seed=SEED)))
    amps = [dense.amplitude(b) for b in samples]
    lazy_amps, asecs = _timed(lambda: [lazy.amplitude(b) for b in samples])
    rel = max(abs(a - b) / abs(b) for a, b in zip(amps, lazy_amps))
    ZZ = np.kron(np.diag([1.0, -1.0]), np.diag([1.0, -1.0]))
    zz_d, zsecs = _timed(lambda: complex(dense.local_expectation(ZZ,
                                                                 (13, 14))))
    zz_l = complex(lazy.local_expectation(ZZ, (13, 14)))
    dzz = abs(zz_d - zz_l)
    print(f"CircuitDense, {CDENSE_N} qubits ({2**CDENSE_N * 16 / 1e9:.2f} "
          f"GB complex128): {ngates} gates in {gsecs:.3f} s "
          f"({gsecs / ngates * 1e3:.3f} ms a gate; start state {isecs:.3f} "
          f"s); | |psi| - 1 | {abs(nrm - 1):.3e} (bound "
          f"{CDENSE_NORM_TOL:.0e}); sample({CDENSE_SAMPLES}, seed={SEED}) "
          f"{samples} in {ssecs:.3f} s (|psi|^2 to the host and "
          f"default_rng's draw); their amplitudes against the lazy "
          f"Circuit's (computed in {asecs:.3f} s): relative {rel:.3e} "
          f"(bound {CDENSE_AMP_TOL:.0e}); <ZZ> on qubits 13, 14 "
          f"{zz_d.real!r} in {zsecs:.3f} s, the lazy Circuit's "
          f"{zz_l.real!r}, distance {dzz:.3e}; peak "
          f"{_peak_from(base):.3f} GB", flush=True)
    if not (abs(nrm - 1) <= CDENSE_NORM_TOL and rel <= CDENSE_AMP_TOL
            and dzz <= CDENSE_AMP_TOL):
        raise AssertionError("CircuitDense misses the lazy Circuit")
    # CircuitBase's xeb keeps |psi|^2 on the card and reads one number;
    # simulate_counts draws as sample does, from the same host |psi|^2
    xeb, xsecs = _timed(lambda: dense.xeb(samples))
    (xeb_p, copied), psecs = _timed(lambda: _d2h_bytes(
        lambda: dense.xeb(samples)))
    counts, csecs = _timed(lambda: dense.simulate_counts(CDENSE_SAMPLES,
                                                         seed=SEED))
    print(f"CircuitDense xeb of the {CDENSE_SAMPLES} strings: {xeb!r} in "
          f"{xsecs:.3f} s; again under torch.profiler ({psecs:.3f} s): "
          f"{copied} bytes from the card (bound {CDENSE_XEB_BYTES}; "
          f"|psi|^2 is {2**CDENSE_N * 8} bytes); "
          f"simulate_counts({CDENSE_SAMPLES}, "
          f"seed={SEED}) {counts} in {csecs:.3f} s, sample's strings "
          f"{'counted alike' if counts == Counter(samples) else 'differ'}",
          flush=True)
    if not (math.isfinite(xeb) and xeb_p == xeb
            and copied <= CDENSE_XEB_BYTES and counts == Counter(samples)):
        raise AssertionError("CircuitDense's xeb or simulate_counts")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("CircuitDense launched a sandwich kernel")
    del dense, lazy
    torch.cuda.empty_cache()
    print(f"CircuitDense phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 29: VMC on a 6 x 6 PEPS, CTMRG, marginals -------------------------

# quimb_tpu's values of phase 29, from scripts/slice16_reference.py
SLICE16_REF = "scripts/slice16_reference.json"
# TNVMC on the 6 x 6 open-boundary Heisenberg PEPS at D=4 in float64, with
# 128 chains: the fixed-configuration values against quimb_tpu's
# (relative to the largest magnitude: float64 rounding through a
# 36-tensor contraction and a 10,368-unknown solve) and the amplitudes
# against the port's own isel + contract. The SR update's delta within
# VMC_SOLVE_FACTOR times its solve's forward-error bound (cond(S) * eps)
# of quimb_tpu's.
VMC_TOL, VMC_ISEL_TOL, VMC_SOLVE_FACTOR = 1e-10, 1e-12, 10
# The Monte Carlo estimates. Each sampler runs 128 chains, half from one
# kind of start and half from another; after its burn-in (proposal steps
# a chain) it takes VMC_SAMPLES samples a chain, one sweep (36 steps)
# apart. An estimate's error is the spread of the chains' own means over
# sqrt(chains): the chains are independent, so it allows for the
# correlation within a chain. Single-flip Metropolis chains (random and
# Neel starts) reach every magnetisation: the two halves agree within
# VMC_SIGMAS combined errors and their estimate lies within max(5 sigma,
# 3 %) of the state's energy by quimb_tpu's boundary contraction at
# chi = 64. Their samples at S^z = 0 estimate the energy of the state's
# S^z = 0 part (a ratio estimate over the chains), which is what the
# exchange chains sample: those start half from Neel states and half from
# the single-flip chains' last S^z = 0 configurations, their halves agree
# and their estimate lies within VMC_SIGMAS combined errors of the
# single-flip chains' S^z = 0 part. The exchange moves swap neighbours in
# the sites' linear order and relax slowly (on an H100 chains from random
# half-filled starts read -17.77 and -18.76 after 20,000 and 100,000
# steps, Neel starts -19.08 and -18.75), hence these starts. Then
# VMC_STEPS SR steps on the exchange chains, none more than 3 sigma above
# their estimate.
VMC_SIGMAS, VMC_REL, VMC_SAMPLES = 5, 0.03, 64
VMC_FLIP_BURN, VMC_EXCHANGE_BURN = 5000, 30000
VMC_RISE_SIGMAS, VMC_STEPS = 3, 3
# translationally invariant CTMRG of the 2D Ising model at beta_c; log10 Z
# against quimb_tpu's, relative
CTMRG_TOL = 1e-10
# the marginals of every bond of phase 22's exact 3 x 3 x 3 Ising network,
# by one gradient against one contraction per (bond, value)
MARG_L, MARG_TOL = 3, 1e-10


def _slice16_reference(part):
    return json.loads(Path(SLICE16_REF).read_text())[part]


def _vmc_state(ref):
    """The reference's start PEPS on the card, float64, its Heisenberg
    builder and a TNVMC with 128 exchange chains."""
    from quimb_torch.experimental import ExchangeSampler, TNVMC
    from quimb_torch.operator import heisenberg_from_edges

    Lx, Ly = ref["Lx"], ref["Ly"]
    arrays = [torch.tensor(a, dtype=torch.float64, device="cuda").reshape(sh)
              for a, sh in zip(ref["arrays"], ref["shapes"])]
    psi = quimb_torch.PEPS([[arrays[i * Ly + j] for j in range(Ly)]
                            for i in range(Lx)], shape="urdlp")
    edges = []
    for i in range(Lx):
        for j in range(Ly):
            if i + 1 < Lx:
                edges.append((i * Ly + j, (i + 1) * Ly + j))
            if j + 1 < Ly:
                edges.append((i * Ly + j, i * Ly + j + 1))
    H = heisenberg_from_edges(edges)
    n, nchains = Lx * Ly, ref["nconf"]
    vmc = TNVMC(psi, H, sampler=ExchangeSampler(n, nchains=nchains,
                                                seed=SEED),
                nchains=nchains, learning_rate=0.05, sr_damping=1e-3)
    return psi, vmc


def _neel_starts(Lx, Ly, count):
    """``count`` chains' starts: the two Neel states of the lattice, in
    turn."""
    neel = np.array([(i + j) % 2 for i in range(Lx) for j in range(Ly)])
    return np.stack([neel, 1 - neel] * (count // 2))


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _vmc_fixed(psi, vmc, ref):
    """Phase 29(a): the fixed-configuration values against quimb_tpu's,
    each stage timed on this batch."""
    configs = torch.tensor(ref["configs"], dtype=torch.int64, device="cuda")
    params = vmc.params
    # warm-up: each stage's first call finds its contraction path
    vmc._grad_logs(params, configs)
    vmc._local_energies(params, configs)
    amps, t_amp = _timed(lambda: vmc._log_amp_batch(params, configs))
    e_loc, t_le = _timed(lambda: vmc._local_energies(params, configs))
    O, t_grad = _timed(lambda: vmc._grad_logs(params, configs))
    v = np.random.default_rng(ref["seeds"]["v"]).standard_normal(
        ref["nparams"])
    vt = torch.tensor(v, device="cuda")
    w = torch.ones(configs.shape[0], dtype=torch.float64, device="cuda")
    (new, e_mean, e_err), t_upd = _timed(lambda: vmc._update(params,
                                                              configs, w))
    delta = torch.cat([(p - q).reshape(-1) for p, q in zip(params, new)]
                      ) / vmc.learning_rate
    sites = list(psi.sites)
    host_configs = ref["configs"]
    iamps, t_isel = _timed(lambda: [complex(psi.isel({
        psi.site_ind(s): int(c[k]) for k, s in enumerate(sites)}).contract(
            ...)).real for c in host_configs])
    errs = {
        "amplitudes": _rel_max(to_host(amps), ref["amps"]),
        "local energies": _rel_max(to_host(e_loc), ref["e_loc"]),
        "O @ v": _rel_max(to_host(O @ vt), ref["O_v"]),
        "|delta|": abs(float(torch.linalg.norm(delta)) - ref["delta_norm"])
        / ref["delta_norm"],
        "step energy": abs(float(e_mean) - ref["step_energy"][0])
        / abs(ref["step_energy"][0]),
    }
    # delta solves S delta = F with S's condition number near 1e8: two
    # float64 solves agree to about cond * eps, so delta itself is held to
    # VMC_SOLVE_FACTOR * cond * eps (delta . v is printed: it cancels to
    # 2e-4 of |delta| |v|)
    d_ref = torch.tensor(ref["delta"], dtype=torch.float64, device="cuda")
    d_err = float(torch.linalg.norm(delta - d_ref) / torch.linalg.norm(d_ref))
    d_bound = VMC_SOLVE_FACTOR * ref["S_cond"] * 2.0 ** -52
    dv = float(delta @ vt)
    isel_err = _rel_max(to_host(amps), iamps)
    print(f"TNVMC 6x6 D=4 PEPS, {ref['nparams']} parameters, "
          f"{configs.shape[0]} fixed S^z=0 configurations: amplitudes "
          f"{t_amp * 1e3:.2f} ms, local energies {t_le * 1e3:.2f} ms "
          f"({vmc._flip_bits.shape[0]} flip masks in one batch), O "
          f"{t_grad * 1e3:.2f} ms (one backward pass), the SR update "
          f"{t_upd * 1e3:.2f} ms; against quimb_tpu's (relative, bound "
          f"{VMC_TOL:.0e}): "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; delta against quimb_tpu's {d_err:.3e} (bound {d_bound:.3e}: "
          f"S's condition number {ref['S_cond']:.4e}), delta . v {dv!r}, "
          f"quimb_tpu's {ref['delta_v']!r}; amplitudes against "
          f"{len(host_configs)} isel + contract ({t_isel:.2f} s): "
          f"{isel_err:.3e} (bound {VMC_ISEL_TOL:.0e})", flush=True)
    if not (max(errs.values()) <= VMC_TOL and isel_err <= VMC_ISEL_TOL
            and d_err <= d_bound):
        raise AssertionError("TNVMC's fixed-configuration values miss "
                             "quimb_tpu's")


def _vmc_chains(vmc, burn):
    """``burn`` proposal steps, then VMC_SAMPLES samples a chain one sweep
    apart: the local energies (samples, chains) and the configurations
    (samples, chains, sites), on the host, with the seconds of each."""
    _, t_burn = _timed(lambda: vmc._sample_batch(vmc.params, burn))

    def draw():
        es, cs = [], []
        for _ in range(VMC_SAMPLES):
            c = vmc._sample_batch(vmc.params, vmc.sweeps_per_sample)
            es.append(vmc._local_energies(vmc.params, c))
            cs.append(c)
        return to_host(torch.stack(es)), to_host(torch.stack(cs))

    (e_loc, configs), t_draw = _timed(draw)
    return e_loc, configs, t_burn, t_draw


def _chain_mean(e_loc):
    """The mean over chains of each chain's mean, and its error."""
    means = e_loc.mean(axis=0)
    return float(means.mean()), float(means.std(ddof=1)
                                      / math.sqrt(means.size))


def _sector_part(e_loc, configs, n_up):
    """The ratio estimate of the energy of the samples with ``n_up`` spins
    up, its error over the chains (the delta method) and their count."""
    ins = configs.sum(axis=2) == n_up
    count, total = ins.sum(axis=0), (e_loc * ins).sum(axis=0)
    r = float(total.sum() / count.sum())
    nc = count.size
    se = math.sqrt(float(((total - r * count) ** 2).sum())
                   / (nc * (nc - 1))) / float(count.mean())
    return r, se, int(count.sum())


def _halves(e_loc, kinds):
    """The estimate of each half of the chains and of all, with the
    distance between the halves over their combined error."""
    h = e_loc.shape[1] // 2
    (a, sa), (b, sb) = _chain_mean(e_loc[:, :h]), _chain_mean(e_loc[:, h:])
    e, se = _chain_mean(e_loc)
    z = abs(a - b) / math.hypot(sa, sb)
    text = (f"{kinds[0]} starts {a!r} +- {sa:.4f}, {kinds[1]} starts {b!r} "
            f"+- {sb:.4f} ({z:.2f} combined errors apart, bound "
            f"{VMC_SIGMAS}); all {e!r} +- {se:.4f}")
    return e, se, z, text


def _vmc_estimates(vmc, ref, e_exact):
    """Phase 29(b)'s estimates: the single-flip chains against the state's
    energy, their S^z = 0 part against the exchange chains. Leaves ``vmc``
    on its exchange chains, burnt in; returns their estimate."""
    from quimb_torch.experimental import MetropolisHastingsSampler, TNVMC

    Lx, Ly, nchains = ref["Lx"], ref["Ly"], vmc.nchains
    n, half = Lx * Ly, nchains // 2
    rng = np.random.default_rng(SEED)
    starts = np.concatenate([rng.integers(0, 2, (half, n)),
                             _neel_starts(Lx, Ly, nchains - half)])
    flip = TNVMC(vmc.psi, vmc.ham, nchains=nchains,
                 sampler=MetropolisHastingsSampler(
                     n, nchains=nchains, initial=starts, seed=SEED))
    e_loc, configs, t_burn, t_draw = _vmc_chains(flip, VMC_FLIP_BURN)
    e_f, se_f, z_f, text = _halves(e_loc, ("random", "Neel"))
    bound = max(VMC_SIGMAS * se_f, VMC_REL * abs(e_exact))
    r, se_r, count = _sector_part(e_loc, configs, n // 2)
    nup = configs.sum(axis=2)
    print(f"TNVMC single-flip chains, {nchains}, {VMC_FLIP_BURN} proposal "
          f"steps ({t_burn:.3f} s) and {VMC_SAMPLES} samples a chain "
          f"({t_draw:.3f} s): {text}; quimb_tpu's boundary contraction "
          f"{e_exact!r} (chi 64; chi 32 {ref['energy']['32']!r}), distance "
          f"{abs(e_f - e_exact):.4f} (bound {bound:.4f}); n_up "
          f"{nup.mean():.3f} +- {nup.std():.3f}, S^z=0 part {r!r} +- "
          f"{se_r:.4f} ({count} samples)", flush=True)
    if not (z_f <= VMC_SIGMAS and abs(e_f - e_exact) <= bound):
        raise AssertionError("the single-flip estimate misses the state's "
                             "energy, or its halves disagree")
    # each chain's last S^z = 0 configuration: starts from the state's own
    # S^z = 0 distribution
    ins = nup == n // 2
    last = ins.shape[0] - 1 - np.argmax(ins[::-1], axis=0)
    eq = configs[last, np.arange(nchains)]
    if not ins.any(axis=0).all():
        raise AssertionError("a single-flip chain never reached S^z = 0")
    vmc.sampler.configs = torch.as_tensor(np.concatenate([
        _neel_starts(Lx, Ly, half), eq[:nchains - half]]))
    e_loc, configs, t_burn, t_draw = _vmc_chains(vmc, VMC_EXCHANGE_BURN)
    e_x, se_x, z_x, text = _halves(e_loc, ("Neel", "S^z=0 equilibrium"))
    zr = abs(e_x - r) / math.hypot(se_x, se_r)
    print(f"TNVMC exchange chains, {nchains}, {VMC_EXCHANGE_BURN} proposal "
          f"steps ({t_burn:.3f} s, {t_burn / VMC_EXCHANGE_BURN * 1e3:.3f} ms "
          f"a step) and {VMC_SAMPLES} samples a chain ({t_draw:.3f} s): "
          f"{text}; {zr:.2f} combined errors from the single-flip chains' "
          f"S^z=0 part (bound {VMC_SIGMAS})", flush=True)
    if not ((configs.sum(axis=2) == n // 2).all() and z_x <= VMC_SIGMAS
            and zr <= VMC_SIGMAS):
        raise AssertionError("the exchange estimate misses the S^z = 0 "
                             "part, or its halves disagree")
    return e_x, se_x


def _vmc_step_breakdown(vmc):
    """One SR step as step() runs it, each stage on a synchronised clock:
    sampling, local energies, gradients, and the rest of the update (the
    S matrix and its solve)."""
    from quimb_torch.experimental import tnvmc

    stages = {}

    def timed_method(name, fn):
        def wrapper(*args):
            out, secs = _timed(lambda: fn(*args))
            stages[name] = stages.get(name, 0.0) + secs
            return out
        return wrapper

    reads0 = sum(tnvmc.HOST_READS.values())
    vmc._sample_batch = timed_method("sampling", vmc._sample_batch)
    vmc._local_energies = timed_method("local energies",
                                       vmc._local_energies)
    vmc._grad_logs = timed_method("gradients", vmc._grad_logs)
    vmc._update = timed_method("update", vmc._update)
    try:
        (e, err), secs = _timed(vmc.step)
    finally:
        for name in ("_sample_batch", "_local_energies", "_grad_logs",
                     "_update"):
            del vmc.__dict__[name]
    stages["solve and the rest"] = (stages.pop("update")
                                    - stages["local energies"]
                                    - stages["gradients"])
    return e, err, secs, stages, sum(tnvmc.HOST_READS.values()) - reads0


def run_tnvmc():
    """Phase 29(a)-(b): TNVMC on the 6 x 6 Heisenberg PEPS at D=4."""
    ref = _slice16_reference("vmc")
    e_exact = ref["energy"]["64"]
    psi, vmc = _vmc_state(ref)
    if not all(p.is_cuda and p.dtype == torch.float64 for p in vmc.params):
        raise AssertionError("the TNVMC parameters are not float64 on the "
                             "card")
    _vmc_fixed(psi, vmc, ref)
    e0, se0 = _vmc_estimates(vmc, ref, e_exact)
    base = _fresh_peak()
    energies = []
    for k in range(VMC_STEPS):
        e, err, secs, stages, reads = _vmc_step_breakdown(vmc)
        energies.append((e, err))
        print(f"  SR step {k}: E {e!r} +- {err:.4f}, {secs:.3f} s ("
              + ", ".join(f"{n} {t:.3f}" for n, t in stages.items())
              + f"), {reads} host reads of its values", flush=True)
    peak = _peak_from(base)
    syncs = _syncs(vmc.step)
    share, top, wall_us, count = _busy_share(vmc.step)
    print(f"TNVMC SR steps: peak allocation {peak:.3f} GB (S is "
          f"{ref['nparams'] ** 2 * 8 / 1e9:.3f} GB), {syncs} host syncs a "
          f"step, one step under torch.profiler {wall_us / 1e6:.3f} s wall, "
          f"{count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    rise = max(e - e0 - VMC_RISE_SIGMAS * max(se0, err)
               for e, err in energies)
    if rise > 0:
        raise AssertionError("an SR step's energy rose above the start's")


def run_ctmrg_2d():
    """Phase 29(c): the 2D Ising partition function at beta_c by the
    translationally invariant CTMRG, against quimb_tpu's."""
    from quimb_torch.experimental import (
        classical_ising_T_A_C,
        ctmrg_partition_function,
    )

    ref = _slice16_reference("ctmrg")
    T, A, C = classical_ising_T_A_C(ref["beta"])
    (Z, exponent), secs = _timed(lambda: ctmrg_partition_function(
        T, A, C, ref["L"], ref["max_bond"], strip_exponent=True))
    log10_z = math.log10(float(Z)) + exponent
    rel = abs(log10_z - ref["log10_Z"]) / abs(ref["log10_Z"])
    print(f"CTMRG 2D Ising L={ref['L']} max_bond={ref['max_bond']} at "
          f"beta_c: {secs:.3f} s ({ref['L'] // 2 - 2} growth steps, "
          f"quimb_tpu's host run {ref['seconds']:.1f} s), log10 Z "
          f"{log10_z!r}, quimb_tpu's {ref['log10_Z']!r}, relative {rel:.3e} "
          f"(bound {CTMRG_TOL:.0e})", flush=True)
    if not (T.is_cuda and rel <= CTMRG_TOL):
        raise AssertionError("CTMRG's log Z misses quimb_tpu's")


def run_marginals():
    """Phase 29(d): the marginals of every bond of phase 22's 3 x 3 x 3 Ising
    network by autodiff, against slicing."""
    from quimb_torch.experimental import (
        compute_all_marginals_via_autodiff,
        compute_all_marginals_via_slicing,
    )

    tn = _ising(MARG_L)
    inds = sorted(tn.inner_inds())
    grad, t_grad = _timed(lambda: compute_all_marginals_via_autodiff(
        tn, inds))
    sliced, t_slice = _timed(lambda: compute_all_marginals_via_slicing(
        tn, inds))
    err = max(float(np.max(np.abs(grad[ix] - sliced[ix]))) for ix in inds)
    print(f"marginals of the {len(inds)} bonds of the {MARG_L}^3 Ising "
          f"network: one gradient {t_grad:.3f} s, {2 * len(inds)} sliced "
          f"contractions {t_slice:.3f} s, largest distance {err:.3e} (bound "
          f"{MARG_TOL:.0e})", flush=True)
    if not err <= MARG_TOL:
        raise AssertionError("the marginals by autodiff miss slicing's")


def run_slice16():
    """Phase 29: TNVMC, CTMRG and the marginals, launching no sandwich
    kernel."""
    t_phase = time.perf_counter()
    _reset_launches()
    run_tnvmc()
    run_ctmrg_2d()
    run_marginals()
    if sum(ck.LAUNCHES.values()):
        raise AssertionError("phase 29 launched a sandwich kernel")
    torch.cuda.empty_cache()
    print(f"VMC, CTMRG and marginals phase: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# -- phase 30: the multi-device layer in a one-rank NCCL world ----------------

# the card's one rank: NCCL runs no two ranks on one GPU, so the mesh
# layer runs in a one-rank world, where every block is whole and the
# sharded paths do the unsharded arithmetic (multi-rank runs: the CPU
# tests' 4-rank gloo worlds)
SHARD_TOL = 1e-12
SHARD_SLICES = 16
SHARD_TEBD_STEPS = 4
SHARD_SAMPLES = 2
SHARD_EXPM_NCV = 32
SHARD_EXACT_RESTARTS = 30
SHARD_SLQ_R, SHARD_SLQ_K = 32, 40
SHARD_SLQ_TOL = 1e-10
# 30(g): DMRGX on the CPU tests' chain; SpinHam1D's dense form at 12 sites
DMRGX_L, DMRGX_CHI, SPIN_HAM_L = 12, 8, 12


def _power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _on_card_blocks(envs, what):
    """Each DTensor environment's block on the card."""
    if not all(e.to_local().is_cuda for e in envs if e is not None):
        raise AssertionError(f"{what}: an environment block left the card")


def run_sharded_dmrg(dmrg):
    """Phase 30(a): one DMRG2 sweep of the float64 L=128, chi=256 state
    under ``shard_onto(get_mesh_2d())`` against one unsharded sweep, each
    from its own copy; then the same on a float32 copy. Returns the
    sharded sweeps' kernel launches, by dtype."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from quimb_torch.parallel import get_mesh_2d

    t_phase = time.perf_counter()
    state = dmrg.state
    mesh, mesh_s = _timed(get_mesh_2d)
    # NCCL sets up a communicator at a group's first collective: once for
    # the world and each of the mesh's two axes, before the timed sweeps
    _, warm_s = _timed(lambda: [dist.all_reduce(
        torch.ones(1, device="cuda"), group=g)
        for g in (None, mesh.get_group(0), mesh.get_group(1))])
    print(f"phase 30: the mesh in {mesh_s:.3f} s, its NCCL communicators in "
          f"{warm_s:.3f} s", flush=True)
    print(f"phase 30: a {dist.get_world_size()}-rank {dist.get_backend()} "
          f"world, mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
          f"{mesh.device_type}:{torch.cuda.current_device()}; {_power()}",
          flush=True)
    opts = dmrg.opts
    min_launches = (max(2 * opts["local_eig_ncv"], opts["local_eig_ncv_floor"])
                    * opts["local_eig_restarts"] * (L - 1))
    launches = {}
    for dtype in (torch.float64, torch.float32):
        kernel = KERNEL_NAME[dtype]
        H = quimb_torch.MPO_ham_heis(L, dtype=dtype, device="cuda")
        p0 = state.astype(dtype)
        ens, secs = {}, {}
        for shard in (True, False):
            engine = quimb_torch.DMRG2(H, bond_dims=CHI, cutoffs=0.0,
                                       p0=p0.copy())
            if shard:
                engine.shard_onto(mesh)
                sharded = engine
            _reset_launches()
            ens[shard], secs[shard] = _timed(lambda: engine.sweep(
                "R", max_bond=CHI, cutoff=0.0, canonize=True))
            if shard:
                n = _sweep_launches(kernel, dict.fromkeys(ck.LAUNCHES, 0),
                                    min_launches, "the sharded sweep")
                launches[dtype] = n[kernel]
        rel = abs(ens[True] - ens[False]) / abs(ens[False])
        renv = sharded._build_right_envs()
        _on_card_blocks(renv, "the sharded sweep")
        bulk = renv[L // 2]
        print(f"{dtype} sharded sweep R: {secs[True]:.3f} s, energy "
              f"{ens[True]!r}, {kernel} launches {launches[dtype]} (at least "
              f"{min_launches}); unsharded {secs[False]:.3f} s, energy "
              f"{ens[False]!r}; relative {rel:.3e} (bound {SHARD_TOL:.0e}); "
              f"a bulk right environment {tuple(bulk.shape)} placed "
              f"{bulk.placements}, block {tuple(bulk.to_local().shape)} on "
              f"{bulk.to_local().device}", flush=True)
        if not (rel <= SHARD_TOL and isinstance(bulk.placements[1], Shard)):
            raise AssertionError(f"{dtype}: the sharded sweep misses the "
                                 f"unsharded one, or is not sharded")
        if dtype == torch.float64:
            _, again_s = _timed(lambda: sharded.sweep("L", max_bond=CHI,
                                                      cutoff=0.0))
            print(f"a second sharded float64 sweep (L): {again_s:.3f} s",
                  flush=True)
            by_name, wall_us, count = _device_kernels(lambda: sharded.sweep(
                "R", max_bond=CHI, cutoff=0.0, canonize=False))
            busy = sum(by_name.values())
            # NCCL's kernels; in a one-rank world it launches none, and the
            # collectives' share waits for a world of several cards
            coll = sum(us for name, us in by_name.items()
                       if name.startswith("nccl"))
            print(f"a third sharded float64 sweep (R) under torch.profiler: "
                  f"{wall_us / 1e6:.3f} s wall, {count} device activities, "
                  f"busy share " + (f"{busy / wall_us:.4f}" if busy > 0
                                    else "not measured")
                  + f"; NCCL kernels {coll / 1e3:.3f} ms ("
                  + (f"{coll / busy:.4f}" if busy > 0 else "not measured")
                  + " of the device time)", flush=True)
            for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
                print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
        del sharded, engine, renv, bulk
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"phase 30(a): {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _sharded_exact(mesh, expm_z0):
    """Phase 30(b): the exact 20-qubit core through the row-sharded
    operator: its matvec against the port's SparseHam, its Lanczos energy
    against REFBASE and Evolution's protocol (four Krylov updates of t =
    1/4 on a 32-vector basis) against phase 11's <Z_0>."""
    from quimb_torch import parallel as par

    e_ref, _ = _exact_reference()
    H = quimb_torch.ham_heis(EXACT_N, sparse=True)
    Hs, build_s = _timed(lambda: par.ShardedSparseHam(H, mesh=mesh))
    ell = core.SparseHam(H)
    n = H.shape[0]
    x = _cuda(np.random.default_rng(SEED).standard_normal(n), torch.float64)
    xs = Hs.shard_vector(x)
    want = ell.matvec(x)
    rel = (torch.linalg.norm(Hs.matvec(xs)[:n] - want)
           / torch.linalg.norm(want)).item()
    ms = [_event_ms(f, (a,), reps=20) for f, a in
          ((Hs.matvec, xs), (ell.matvec, x), (Hs.matvec, xs),
           (ell.matvec, x))]
    (lam, _), lanczos_s = _timed(lambda: par.eigh_lanczos_sharded(
        Hs, ncv=EXACT_NCV, restarts=SHARD_EXACT_RESTARTS))
    rel_e = abs(float(lam) - e_ref) / abs(e_ref)
    bit0 = (np.arange(n) >> (EXACT_N - 1)) & 1
    zdiag = 1.0 - 2.0 * bit0
    psi = quimb_torch.computational_state("01" * (EXACT_N // 2)).reshape(-1)
    zs, t0 = [], time.perf_counter()
    for _ in range(EXACT_NT):
        psi = par.expm_multiply_sharded(Hs, psi, t=-1j * EXACT_T / EXACT_NT,
                                        ncv=SHARD_EXPM_NCV)
        p = np.abs(psi) ** 2
        zs.append(float(np.sum(p * zdiag) / np.sum(p)))
    expm_s = time.perf_counter() - t0
    dz = float(np.max(np.abs(np.asarray(zs) - np.asarray(expm_z0))))
    print(f"ShardedSparseHam(ham_heis({EXACT_N})): built in {build_s:.3f} s "
          f"({Hs.rows_per} rows x {Hs.V.shape[-1]} a rank, V placed "
          f"{Hs.V.placements}, on {Hs.V.to_local().device}); matvec against "
          f"SparseHam relative {rel:.3e} (bound {EXACT_MV_TOL:.0e}); ms "
          f"sharded, SparseHam, sharded, SparseHam {[round(m, 4) for m in ms]}"
          f"; eigh_lanczos_sharded {float(lam)!r} in {lanczos_s:.3f} s, "
          f"relative to REFBASE {rel_e:.3e} (bound {EXACT_E_TOL:.0e}); four "
          f"expm_multiply_sharded updates {expm_s:.3f} s, <Z_0> against "
          f"phase 11's max {dz:.3e} (bound {EXACT_Z_TOL:.0e})", flush=True)
    if not (rel <= EXACT_MV_TOL and rel_e <= EXACT_E_TOL
            and dz <= EXACT_Z_TOL):
        raise AssertionError("the row-sharded exact core misses its "
                             "references")
    return H, ell


def _sharded_circuit(mesh):
    """Phase 30(c): the 53-qubit amplitude by contract_sliced over 16
    slices batched on the card and by amplitude(mesh=), against REFBASE;
    sample(mesh=) against the unsharded per-sample draw of a fresh
    circuit."""
    from quimb_torch import parallel as par
    from quimb_torch.tensor.circuit.core import _network_to_device

    qasm = _circuit_qasm()
    b0 = "0" * CIRC_N
    want = _circuit_reference()[b0]
    tol = CIRC_AMP_TOL[torch.complex128]
    circ = quimb_torch.tensor.Circuit.from_openqasm2_str(
        qasm, dtype=torch.complex128)
    tn = circ.amplitude(b0, rehearse=True)["tn"]
    tn = _network_to_device(tn, circ.device)
    sliced = par.choose_sliced_inds(tn, SHARD_SLICES)
    nslices = math.prod(tn.ind_size(ix) for ix in sliced)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    amp, secs = _timed(lambda: complex(par.contract_sliced(
        tn, sliced, mesh=mesh, optimize="auto")))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    rel = abs(amp - want) / abs(want)
    amp_mesh, mesh_s = _timed(lambda: circ.amplitude(b0, mesh=mesh))
    rel_mesh = abs(amp_mesh - want) / abs(want)
    print(f"53-qubit amp0 by contract_sliced over {len(sliced)} indices, "
          f"{nslices} slices batched on the card: {amp!r} in {secs:.3f} s, "
          f"peak {peak:.3f} GB, relative to REFBASE {rel:.3e}; "
          f"amplitude(mesh=) {mesh_s:.3f} s, relative {rel_mesh:.3e} (bound "
          f"{tol:.0e})", flush=True)
    if not (nslices >= SHARD_SLICES and rel <= tol and rel_mesh <= tol):
        raise AssertionError("the sliced 53-qubit amplitude misses REFBASE")
    fresh = quimb_torch.tensor.Circuit.from_openqasm2_str
    got, got_s = _timed(lambda: list(fresh(qasm).sample(
        SHARD_SAMPLES, seed=CIRC_SEED, mesh=mesh)))
    # the same per-sample route without the mesh (contract_opts given)
    ref, ref_s = _timed(lambda: list(fresh(qasm).sample(
        SHARD_SAMPLES, seed=CIRC_SEED, backend=None)))
    print(f"sample({SHARD_SAMPLES}, seed={CIRC_SEED}, mesh=) {got_s:.3f} s "
          f"{got}; the unsharded per-sample draw {ref_s:.3f} s "
          f"{'equal' if got == ref else ref}", flush=True)
    if got != ref:
        raise AssertionError("sample(mesh=) differs from the unsharded draw")


def _sharded_tebd(mesh):
    """Phase 30(d): phase 10's complex128 quench, SHARD_TEBD_STEPS steps
    under shard_onto(get_mesh()) against as many unsharded steps."""
    opts = {"max_bond": TEBD_CHI, "cutoff": TEBD_CUTOFF}
    ents, secs = {}, {}
    for shard in (True, False):
        tebd = quimb_torch.TEBD(quimb_torch.MPS_neel_state(
            TEBD_L, dtype=torch.float64), quimb_torch.ham_1d_heis(TEBD_L),
            split_opts=opts, progbar=False)
        if shard:
            tebd.shard_onto(mesh)
        ents[shard] = []
        t0 = time.perf_counter()
        for k in range(1, SHARD_TEBD_STEPS + 1):
            tebd.update_to(k * TEBD_DT, dt=TEBD_DT)
            ents[shard].append(tebd.entropy(TEBD_L // 2))
        torch.cuda.synchronize()
        secs[shard] = time.perf_counter() - t0
        if shard:
            Bs = tebd._vidal[0]
            if not (Bs.is_cuda and Bs.dtype == torch.complex128):
                raise AssertionError("the sharded TEBD stack left the card")
    dist = float(np.max(np.abs(np.subtract(ents[True], ents[False]))))
    print(f"TEBD L={TEBD_L}, chi={TEBD_CHI}, {SHARD_TEBD_STEPS} steps "
          f"sharded {secs[True]:.3f} s, unsharded {secs[False]:.3f} s; "
          f"entropies apart at most {dist:.3e} (bound {SHARD_TOL:.0e})",
          flush=True)
    if not dist <= SHARD_TOL:
        raise AssertionError("the sharded TEBD misses the unsharded one")


def _sharded_slq(mesh, H, ell):
    """Phase 30(e): tr(H^2) by approx_spectral_sharded on (b)'s operator
    against the unsharded construct_lanczos_tridiag on the same probes."""
    from quimb_torch import parallel as par
    from quimb_torch.linalg.approx_spectral import (
        _operator_matmat, _quadrature_weights, construct_lanczos_tridiag)

    def f(x):
        return x ** 2

    (est, err), secs = _timed(lambda: par.approx_spectral_sharded(
        ell, f, R=SHARD_SLQ_R, K=SHARD_SLQ_K, mesh=mesh, seed=SEED))
    n = H.shape[0]
    V0 = _cuda(np.random.default_rng(SEED).choice(
        [-1.0, 1.0], size=(SHARD_SLQ_R, n)), torch.float64)
    alpha, beta = construct_lanczos_tridiag(_operator_matmat(ell)[0], n,
                                            SHARD_SLQ_K, V0, torch.float64)
    w, tau2 = _quadrature_weights(alpha, beta)
    want = float(np.mean(n * np.sum(to_host(tau2) * f(to_host(w)), axis=1)))
    rel = abs(est - want) / abs(want)
    exact = float(H.multiply(H).sum())
    print(f"approx_spectral_sharded tr(H^2), R={SHARD_SLQ_R}, "
          f"K={SHARD_SLQ_K}: {est!r} +- {err:.4g} in {secs:.3f} s; the "
          f"unsharded recurrence on the same probes {want!r}, relative "
          f"{rel:.3e} (bound {SHARD_SLQ_TOL:.0e}); exact {exact!r} (not "
          f"gated)", flush=True)
    if not rel <= SHARD_SLQ_TOL:
        raise AssertionError("the sharded SLQ misses the unsharded one")


def _sharded_dmrgx_and_spin_ham():
    """Phase 30(g): DMRGX at L=12 under shard_onto(get_mesh_2d()) against
    the unsharded sweeps, bit for bit; SpinHam1D's dense Hamiltonian on
    the card against its host CSR matrix."""
    from quimb_torch.parallel import get_mesh_2d

    mesh = get_mesh_2d()
    H = quimb_torch.MPO_ham_heis(DMRGX_L, j=(1.0, 1.0, 1.3), device="cuda")
    ens = {}
    before = dict(ck.LAUNCHES)
    for shard in (True, False):
        engine = quimb_torch.DMRGX(
            H, quimb_torch.MPS_neel_state(DMRGX_L, dtype=torch.float64),
            bond_dims=DMRGX_CHI, cutoffs=0.0)
        if shard:
            engine.shard_onto(mesh)
        ens[shard], secs = _timed(lambda: [
            engine.sweep(d, max_bond=DMRGX_CHI, cutoff=0.0, canonize=c)
            for d, c in (("R", True), ("L", False))])
        print(f"DMRGX L={DMRGX_L}, chi={DMRGX_CHI}, "
              f"{'sharded' if shard else 'unsharded'}: energies "
              f"{ens[shard]!r} in {secs:.3f} s", flush=True)
    ham = quimb_torch.SpinHam1D(S=1 / 2)
    ham += 1.0, "X", "X"
    ham += 1.0, "Y", "Y"
    ham += 1.0, "Z", "Z"
    ham += 0.3, "Z"
    dense, dsecs = _timed(lambda: ham.build_dense(SPIN_HAM_L))
    sparse, ssecs = _timed(lambda: ham.build_sparse(SPIN_HAM_L))
    _on_card("SpinHam1D.build_dense", dense, torch.complex128)
    dist = float(np.abs(to_host(dense) - sparse.toarray()).max())
    print(f"SpinHam1D(S=1/2).build_dense({SPIN_HAM_L}) {tuple(dense.shape)} "
          f"on {dense.device} in {dsecs:.3f} s; against build_sparse "
          f"({ssecs:.3f} s, {sparse.nnz} nonzeros): {dist:.3e} (bound "
          f"{SHARD_TOL:.0e})", flush=True)
    if ens[True] != ens[False]:
        raise AssertionError("the sharded DMRGX differs from the unsharded")
    if not dist <= SHARD_TOL:
        raise AssertionError("SpinHam1D.build_dense misses build_sparse")
    if dict(ck.LAUNCHES) != before:
        raise AssertionError("phase 30(g) launched a sandwich kernel")


def run_multidevice(expm_z0):
    """Phase 30(b)-(g) in a one-rank NCCL world on the card; no sandwich
    kernel but (f)'s DMRG sweep."""
    import torch.distributed as dist

    from quimb_torch import parallel as par

    t_phase = time.perf_counter()
    mesh = par.get_mesh()
    secs = {}
    t0 = time.perf_counter()
    H, ell = _sharded_exact(mesh, expm_z0)
    secs["b"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for part, fn in (("c", lambda: _sharded_circuit(mesh)),
                     ("d", lambda: _sharded_tebd(mesh)),
                     ("e", lambda: _sharded_slq(mesh, H, ell)),
                     ("f", lambda: par.dryrun_multichip(1)),
                     ("g", _sharded_dmrgx_and_spin_ham)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(f"phase 30(b)-(g): {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items())
          + f"); {_power()}", flush=True)


def main():
    t_start = time.perf_counter()
    check_device()
    build_kernels()
    max_abs_err, north = check_kernel()
    times = {dtype: time_kernel(north, dtype) for dtype in KERNEL_TOLS}
    launches = {}
    dmrg, launches[torch.float32] = run_main_path(torch.float32)
    check_splits(bond_breakdown(dmrg))
    launches[torch.float32] += run_parallel_path(dmrg)
    del dmrg
    dmrg, launches[torch.float64] = run_main_path(torch.float64)
    check_splits(bond_breakdown(dmrg))
    launches[torch.float64] += run_dmrg1_path(dmrg)
    run_tn_layer(dmrg)
    run_mps_layer(dmrg)
    torch.cuda.empty_cache()
    run_compress_1d(dmrg)
    run_spectral(dmrg)
    run_complex_dmrg(dmrg)
    run_jacobi(dmrg)
    sharded = run_sharded_dmrg(dmrg)
    for dtype, n in sharded.items():
        launches[dtype] += n
    del dmrg
    for dtype in TEBD_REAL:
        run_tebd_path(dtype)
    torch.cuda.empty_cache()
    expm_z0 = run_exact_path()
    torch.cuda.empty_cache()
    run_matrix_half(expm_z0)
    run_sector_ed()
    run_circuit_dense()
    torch.cuda.empty_cache()
    run_circuit_path()
    torch.cuda.empty_cache()
    run_circuit_mps_path()
    torch.cuda.empty_cache()
    psi16 = run_peps_path()
    torch.cuda.empty_cache()
    run_ring_dmrg()
    run_ring_tebd()
    t_2d = time.perf_counter()
    run_peps_norms(psi16)
    run_2d_compress(psi16)
    run_full_update()
    print(f"2D layer phase: {time.perf_counter() - t_2d:.1f} s", flush=True)
    run_kagome()
    run_circuit_pepo()
    torch.cuda.empty_cache()
    run_ising_3d()
    run_peps3d()
    run_peps16_bp(psi16)
    del psi16
    run_hyper_bp()
    run_tnoptimizer()
    run_cluster_update()
    run_slice16()
    run_multidevice(expm_z0)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "sandwich_matvec",
        "route": "cuda",
        "source": KERNEL_SOURCE[dtype],
        "replaces": "quimb_tpu/ops/pallas_kernels.py:68",
        "launches": launches[dtype],
        "max_abs_err": max_abs_err[dtype],
        "ms": times[dtype][0],
        "plain_ms": times[dtype][1],
        "bound_ms": sandwich_bound(dtype)[0],
        "bound_by": sandwich_bound(dtype)[1],
        # the plain version is the one library call that computes the
        # product, torch.einsum("xmk,kl,xln->mn")
        "library_ms": times[dtype][1],
    } for dtype in KERNEL_TOLS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
