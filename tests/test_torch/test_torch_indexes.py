"""The public names of quimb_torch's package indexes against quimb_tpu's,
on the CPU: the top level (its ``__all__`` and its lazy index), ``linalg``,
``tensor``, ``utils``, ``experimental`` and ``parallel``. Every public name
of a quimb_tpu index resolves in the port's, less the names stated below:
left out on purpose (ROADMAP queue 1) or still to port (none since item
18). A later gap fails it, and so does a name on these lists that the port
comes to hold (the list is then stale). And the two module trees: every
module of quimb_tpu has its counterpart, less the Pallas kernels (ported as
``ops/cuda_kernels.py``)."""

import importlib
import inspect
import os
import types

import pytest

import quimb_tpu
import quimb_torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: names left out on purpose (ROADMAP queue 1): the BCOO sparse format of
#: JAX and the pytree registration of JAX; ``models`` is listed among
#: quimb_tpu's lazy submodules but no such module exists there
LEFT_OUT = {
    "": {"sparse_to_bcoo", "models"},
    ".tensor": {"jax_register_pytree"},
}
#: names still to port: none (item 18, the last, brought the pools and
#: the ``parallel`` package)
TO_PORT = {}
SUBPACKAGES = ("", ".linalg", ".tensor", ".utils", ".experimental",
               ".parallel")


def _public(mod, lazy=()):
    """The public names of ``mod``: its ``__all__``, its lazy index and
    every public attribute that is not a module it merely imports."""
    names = set(getattr(mod, "__all__", ())) | set(lazy)
    for name in dir(mod):
        if name.startswith("_"):
            continue
        obj = inspect.getattr_static(mod, name, None)
        if isinstance(obj, types.ModuleType) and not obj.__name__.startswith(
                mod.__name__ + "."):
            continue
        names.add(name)
    return names


def _lazy(pkg):
    if pkg is quimb_tpu:
        return set(quimb_tpu._build_lazy_index()) | quimb_tpu._SUBMODULES
    quimb_torch.__getattr__("qu")  # builds the lazy index
    return set(quimb_torch._LAZY_INDEX)


def _import_common(sub):
    """Import every module under ``sub`` that both packages have: an
    imported submodule becomes an attribute of its package, so the names
    compared must not depend on what this process ran before."""
    root = sub.lstrip(".").replace(".", os.sep)
    for rel in sorted(_tree("quimb_tpu") & _tree("quimb_torch")):
        if root and not rel.startswith(root + os.sep):
            continue
        name = rel[:-len(".py")].replace(os.sep, ".")
        name = name[:-len(".__init__")] if name.endswith("__init__") else name
        for pkg in ("quimb_tpu", "quimb_torch"):
            importlib.import_module(f"{pkg}.{name}".rstrip("."))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_index_names_match(sub):
    _import_common(sub)
    j = importlib.import_module("quimb_tpu" + sub)
    t = importlib.import_module("quimb_torch" + sub)
    want = _public(j, _lazy(quimb_tpu) if sub == "" else ())
    have = _public(t, _lazy(quimb_torch) if sub == "" else ())
    stated = LEFT_OUT.get(sub, set()) | TO_PORT.get(sub, set())
    assert sorted(want - have - stated) == []
    assert sorted(stated & have) == []
    assert stated <= want


def test_listed_names_resolve():
    """The names the indexes lacked before item 19 and 16(f): each
    resolves and is the port's own object."""
    from quimb_torch import linalg, tensor, utils

    for name in ("eigh_lanczos", "eigsh", "expm_multiply_krylov",
                 "lobpcg_block"):
        assert getattr(linalg, name) is getattr(
            importlib.import_module("quimb_torch.linalg.lanczos"), name)
    for name in ("tensor_network_gate_inds", "tensor_network_gate_sandwich",
                 "tensor_network_gate_sandwich_inds"):
        assert getattr(tensor, name).__module__ == "quimb_torch.tensor.gating"
    for name in ("LRU", "check_opt", "concat", "ensure_dict", "frequencies",
                 "pairwise", "partition_all", "unique", "valmap"):
        assert getattr(quimb_torch, name) is getattr(utils, name)
    assert set(utils.__all__) == set(quimb_tpu.utils.__all__)


def _tree(pkg):
    root = os.path.join(REPO, pkg)
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")}


def test_module_trees_match():
    missing = _tree("quimb_tpu") - _tree("quimb_torch")
    assert sorted(missing) == [os.path.join("ops", "pallas_kernels.py")]
