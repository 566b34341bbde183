"""quimb_torch's Lanczos basis against quimb_tpu's, with one matvec and
one start vector. The algorithm has no gauge freedom, so the basis
itself is compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quimb_tpu.linalg import lanczos as jl
from quimb_torch.linalg import lanczos as tl


@pytest.mark.parametrize("ncv", [4, 8, 16])
@pytest.mark.parametrize("shape", [(64,), (4, 4, 4)])
def test_lanczos_basis(ncv, shape):
    rng = np.random.default_rng(8)
    H = rng.standard_normal((64, 64))
    H = (H + H.T) / 2
    v0 = rng.standard_normal(shape)

    jH = jnp.asarray(H)
    jV, ja, jb = jl._lanczos_basis(
        lambda x: jnp.reshape(jH @ jnp.reshape(x, (-1,)), x.shape),
        jnp.asarray(v0), ncv,
    )
    tH = torch.from_numpy(H)
    tV, ta, tb = tl._lanczos_basis(
        lambda x: (tH @ x.reshape(-1)).reshape(x.shape),
        torch.from_numpy(v0), ncv,
    )
    # float64 with two reorthogonalisation passes: round-off level
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-10)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-10)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), atol=1e-8)
    np.testing.assert_allclose(tV.numpy() @ tV.numpy().T, np.eye(ncv),
                               atol=1e-12)

    jw, jS = jl._tridiag_eigh(ja, jb)
    tw, tS = tl._tridiag_eigh(ta, tb)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-10)
    # the lowest Ritz value bounds the lowest eigenvalue from above
    assert float(tw[0]) >= np.linalg.eigvalsh(H)[0] - 1e-10
    np.testing.assert_allclose(np.abs(tS[:, 0].numpy()),
                               np.abs(np.asarray(jS)[:, 0]), atol=1e-8)


def test_lanczos_converges_on_small_space():
    """With ncv equal to the dimension, the lowest Ritz value is the
    lowest eigenvalue (the b > 1e-30 guard keeps the exhausted last
    step finite)."""
    rng = np.random.default_rng(9)
    H = rng.standard_normal((6, 6))
    H = torch.from_numpy((H + H.T) / 2)
    V, a, b = tl._lanczos_basis(lambda x: H @ x,
                                torch.from_numpy(rng.standard_normal(6)), 6)
    w, _ = tl._tridiag_eigh(a, b)
    assert torch.isfinite(V).all()
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(H.numpy()),
                               atol=1e-10)
