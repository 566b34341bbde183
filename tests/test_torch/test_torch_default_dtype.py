"""The default-dtype stack of quimb_torch (``config.get_default_dtype``,
``set_default_dtype``, the ``default_dtype`` context manager and the
``QUIMB_TORCH_DTYPE`` environment variable) against quimb_tpu's, on the
CPU: every builder below makes the same dtype in both packages under the
same default, and the stack unwinds after an exception. Also the tensor
linear operators' backend stack, which quimb_tpu sets and never reads."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import quimb_tpu.config as jconfig
import quimb_tpu.core as jcore
import quimb_tpu.gen.rand as jrand
import quimb_tpu.operator as jop
import quimb_tpu.tensor as jtn

import quimb_torch.config as tconfig
import quimb_torch.core as tcore
import quimb_torch.gen.rand as trand
import quimb_torch.operator as top
import quimb_torch.tensor as ttn

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _builder(op_mod):
    b = op_mod.SparseOperatorBuilder()
    for i in range(3):
        b += 1.0, ("z", i), ("z", i + 1)
        b += 0.5, ("x", i), ("x", i + 1)
    return b


#: (name, quimb_tpu's call, the port's call), each returning a dtype
BUILDERS = [
    ("qu", lambda: jcore.qu([[1, 0], [0, 1]]).dtype,
     lambda: tcore.qu([[1, 0], [0, 1]], device=CPU).dtype),
    ("rand_ket", lambda: jrand.rand_ket(4, seed=1).dtype,
     lambda: trand.rand_ket(4, seed=1, device=CPU).dtype),
    ("MPS_rand_state", lambda: jtn.MPS_rand_state(4, 2, seed=1).dtype,
     lambda: ttn.MPS_rand_state(4, 2, seed=1, device=CPU).dtype),
    ("PEPS.rand", lambda: jtn.PEPS.rand(2, 2, 2, seed=1).dtype,
     lambda: ttn.PEPS.rand(2, 2, 2, seed=1, device=CPU).dtype),
    ("Circuit", lambda: jtn.Circuit(2).psi.dtype,
     lambda: ttn.Circuit(2, device=CPU).psi.dtype),
    ("TN_from_sites_product_state",
     lambda: jtn.TN_from_sites_product_state(
         {0: [0.6, 0.8], 1: [1.0, 0.0]}).dtype,
     lambda: ttn.TN_from_sites_product_state(
         {0: [0.6, 0.8], 1: [1.0, 0.0]}, device=CPU).dtype),
    ("SparseOperatorBuilder.build_mpo",
     lambda: _builder(jop).build_mpo().dtype,
     lambda: _builder(top).build_mpo(device=CPU).dtype),
]


@pytest.mark.parametrize("dtype", ["complex64", "float32"])
@pytest.mark.parametrize("name,jfn,tfn", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_builders_follow_the_default_dtype(name, jfn, tfn, dtype):
    with jconfig.default_dtype(dtype), tconfig.default_dtype(dtype):
        want, got = jfn(), tfn()
        assert _name(tconfig.get_default_dtype()) == dtype
        assert _name(tconfig.get_default_real_dtype()) == \
            jconfig.get_default_real_dtype()
    assert _name(got) == _name(want)
    # and outside the context, both are back at complex128's builders
    assert _name(tfn()) == _name(jfn())


def test_the_stack_unwinds_after_an_exception():
    assert tconfig.get_default_dtype() == torch.complex128
    with pytest.raises(RuntimeError, match="inside"):
        with tconfig.default_dtype("float32"):
            with tconfig.default_dtype(torch.complex64):
                assert trand.randn(3, device=CPU).dtype == torch.complex64
                raise RuntimeError("inside")
    assert tconfig.get_default_dtype() == torch.complex128
    assert tconfig.get_default_real_dtype() == torch.float64
    with tconfig.default_dtype("complex64"):
        tconfig.set_default_dtype("float32")
        assert tconfig.get_default_dtype() == torch.float32
    assert tconfig.get_default_dtype() == torch.complex128


def test_environment_variable_sets_the_start():
    code = (
        "import numpy as np\n"
        "import quimb_tpu.tensor as jtn, quimb_tpu.gen.rand as jrand\n"
        "import quimb_torch.tensor as ttn, quimb_torch.gen.rand as trand\n"
        "from quimb_torch import config\n"
        "print(str(config.get_default_dtype()).replace('torch.', ''))\n"
        "print(trand.rand_ket(4, seed=1, device='cpu').dtype == "
        "getattr(__import__('torch'), str(jrand.rand_ket(4, seed=1).dtype)))\n"
        "print(str(ttn.MPS_rand_state(3, 2, device='cpu').dtype)"
        ".replace('torch.', '') == str(jtn.MPS_rand_state(3, 2).dtype))\n"
    )
    env = dict(os.environ, QUIMB_TORCH_DTYPE="complex64",
               QUIMB_TPU_DTYPE="complex64", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["complex64", "True", "True"]


def test_tensor_linop_backend_stack_matches():
    from quimb_tpu.ops import contraction as jc
    from quimb_torch.ops import contraction as tc

    assert tc.get_tensor_linop_backend() == jc.get_tensor_linop_backend()
    with tc.tensor_linop_backend("numpy"), jc.tensor_linop_backend("numpy"):
        assert tc.get_tensor_linop_backend() == "numpy" == \
            jc.get_tensor_linop_backend()
    assert tc.get_tensor_linop_backend() is None
    assert ttn.tensor_linop_backend is tc.tensor_linop_backend
    np.testing.assert_equal(ttn.get_tensor_linop_backend(), None)
