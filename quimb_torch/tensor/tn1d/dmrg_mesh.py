"""The steps of a DMRG sweep over the ranks of a mesh
(:meth:`.dmrg.DMRG.shard_onto`).

quimb_tpu shards the chi axes of its fused scans and lets XLA partition
them; the port's per-site sweep has its own scheme, fitted to the sandwich
matvec ``out (M, N) = sum_x A[x] theta B[x]``:

- Environments are DTensors. Left ones are sharded on their bra chi over
  the first axis, right ones over the second, where the size divides the
  axis (:func:`~quimb_torch.parallel.mesh.mesh_put`'s rule), and
  replicated elsewhere.
- The matvec: a rank's left block gives its rows of ``A`` (M = (a, u), a
  outermost) and its right block its columns of ``B``, laid out as
  (v, b_block) so that each block is contiguous. The sandwich kernel,
  prepared once per local solve, applies them to the whole replicated
  theta; one all-gather over the mesh and one permute and reshape
  assemble the output on every rank.
- The Lanczos solve runs replicated on every rank.
- A split or a gauge move runs on the replicated tensor and the mesh's
  first rank's result is broadcast, so the ranks cannot drift apart.
- An environment step sums over the rank's own bra rows, all-reduces over
  its axis and keeps the rank's block of the new environment.

Site tensors stay whole on every rank.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ...parallel.mesh import (
    _all_gather,
    _all_reduce,
    broadcast_tensors,
    mesh_device,
    mesh_put,
)
from .dmrg import (
    _env_step_left,
    _env_step_right,
    _lanczos_ground,
    _overlap_norm_1site,
    _overlap_norm_2site,
    _sandwich_operands,
    _sandwich_operands_1site,
)


class MeshSweep:
    """:class:`.dmrg._LocalSweep`'s steps over the ranks of ``mesh``,
    environments sharded over ``axes`` (left, right; either may be
    ``None``). ``like`` is a site tensor, on the sweep's device."""

    def __init__(self, mesh, axes, like):
        if mesh_device(mesh) != like.device:
            raise ValueError(f"the mesh's rank is on {mesh_device(mesh)}, "
                             f"the sweep on {like.device}")
        if mesh.size() != dist.get_world_size():
            raise ValueError("the mesh must span the world")
        if axes[0] is not None and axes[0] == axes[1]:
            raise ValueError("the left and right environments need two "
                             f"different axes, not {axes}")
        self.mesh, self.axes = mesh, tuple(axes)
        names = mesh.mesh_dim_names
        self._dims = [None if a is None else names.index(a) for a in axes]
        self._groups = [None if a is None else mesh.get_group(a)
                        for a in axes]
        # every rank's coordinates in the mesh, and the global ranks in the
        # mesh's row-major order (None where that is the ranks' own order)
        grid = mesh.mesh.cpu().numpy()
        me = np.argwhere(grid == dist.get_rank())[0]
        self._me = tuple(int(c) for c in me)
        order = grid.reshape(-1)
        self._order = (None if np.array_equal(order, np.arange(order.size))
                       else torch.as_tensor(order, device=like.device))

    # -- the blocks ----------------------------------------------------------

    def _sharded(self, env, side):
        k = self._dims[side]
        return k is not None and isinstance(env.placements[k], Shard)

    def _rows(self, env, side, coord):
        """The bra rows of ``env`` (the left one for ``side`` 0, the
        right one for 1) that the rank at ``coord`` holds."""
        n = env.shape[0]
        if not self._sharded(env, side):
            return slice(0, n)
        k = self._dims[side]
        m = n // self.mesh.size(k)
        return slice(coord[k] * m, (coord[k] + 1) * m)

    def _assemble(self, blocks, L, R):
        """Theta's shape, (a, ..., b), from every rank's output block
        ``blocks`` (world, a / p_l, ..., b / p_r), in global rank order:
        the blocks laid out on the mesh, the first copy of each kept, and
        one permute and reshape put the row blocks before their rows and
        the column blocks before their columns."""
        if self._order is not None:
            blocks = blocks[self._order]
        shape = tuple(self.mesh.shape)
        blocks = blocks.reshape(*shape, *blocks.shape[1:])
        kl = self._dims[0] if self._sharded(L, 0) else None
        kr = self._dims[1] if self._sharded(R, 1) else None
        blocks = blocks[tuple(slice(None) if k in (kl, kr) else 0
                              for k in range(len(shape)))]
        if kl is None:
            blocks = blocks.unsqueeze(0)
        if kr is None:
            blocks = blocks.unsqueeze(1)
        elif kl is not None and kl > kr:
            blocks = blocks.transpose(0, 1)
        # (p_l, p_r, a / p_l, ..., b / p_r) -> (a, ..., b)
        n = blocks.ndim
        blocks = blocks.permute(0, *range(2, n - 1), 1, n - 1)
        pl, ma, pr, mb = (blocks.shape[0], blocks.shape[1], blocks.shape[-2],
                          blocks.shape[-1])
        return blocks.reshape(pl * ma, *blocks.shape[2:-2], pr * mb)

    def _counts(self, L, R):
        """Whether this rank's (rows, columns) block is the first copy of
        its block: the one that adds to a sum over the mesh."""
        dims = {self._dims[s] for s, env in ((0, L), (1, R))
                if self._sharded(env, s)}
        return all(c == 0 for k, c in enumerate(self._me) if k not in dims)

    def _put(self, env, side):
        return mesh_put(env, self.mesh, (self.axes[side], None, None))

    # -- the steps -----------------------------------------------------------

    def ones_env(self, A, side):
        return self._put(torch.ones((1, 1, 1), dtype=A.dtype,
                                    device=A.device), side)

    def env_right(self, L, A, W):
        """The next left environment: this rank's bra rows of L absorbed,
        summed over the left axis."""
        rows = self._rows(L, 0, self._me)
        part = _env_step_right(L.to_local(), torch.conj(A)[rows], W, A)
        if self._sharded(L, 0):
            part = _all_reduce(part, self._groups[0])
        return self._put(part, 0)

    def env_left(self, R, A, W):
        """The previous right environment, as :meth:`env_right`."""
        rows = self._rows(R, 1, self._me)
        part = _env_step_left(R.to_local(), torch.conj(A)[:, :, rows], W, A)
        if self._sharded(R, 1):
            part = _all_reduce(part, self._groups[1])
        return self._put(part, 1)

    def _solve(self, L, R, theta0, A, B, ncv, restarts, norm_energy,
               sandwich, norm):
        """The replicated Lanczos solve over this rank's sandwich
        operands; the output blocks of every rank gathered into theta's
        shape, (a, ..., b)."""
        heff = sandwich(A, B)
        ra, rb = self._rows(L, 0, self._me), self._rows(R, 1, self._me)
        local = (ra.stop - ra.start, *theta0.shape[1:-1], rb.stop - rb.start)

        def matvec(theta):
            return self._assemble(_all_gather(heff(theta).reshape(local)),
                                  L, R)

        lam, v = _lanczos_ground(matvec, theta0, A.shape[2], B.shape[1],
                                 ncv, restarts)
        if norm_energy:
            part = norm(L.to_local(), R.to_local(), v, v[ra][..., rb])
            if not self._counts(L, R):
                part = torch.zeros_like(part)
            lam = lam / _all_reduce(part)
        return lam, v

    def solve_2site(self, L, W1, W2, R, theta0, ncv, restarts,
                    norm_energy=True, sandwich=None):
        A, B = _sandwich_operands(L.to_local(), W1, W2, R.to_local())
        return self._solve(L, R, theta0, A, B, ncv, restarts, norm_energy,
                           sandwich, _overlap_norm_2site)

    def solve_1site(self, L, W, R, theta0, ncv, restarts, norm_energy=True,
                    sandwich=None):
        A, B = _sandwich_operands_1site(L.to_local(), W, R.to_local())
        return self._solve(L, R, theta0, A, B, ncv, restarts, norm_energy,
                           sandwich, _overlap_norm_1site)

    def share(self, fn):
        """``fn()`` (a split, a gauge move) with the mesh's first rank's
        result on every rank. Every rank runs it on the same replicated
        inputs, so every rank knows the shapes with no host read, and the
        first rank's tensors are broadcast over them: the ranks cannot drift
        apart."""
        return broadcast_tensors(fn())
