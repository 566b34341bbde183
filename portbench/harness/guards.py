"""The run's guards: a CUDA card must be present, and no JAX, nor the JAX
package that quimb_torch ports, may be loaded in the process."""

import sys

#: top-level module names no run may load: JAX and its libraries, and the
#: JAX package the port was made from
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "quimb_tpu"})


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is forbidden, sorted."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


class NoCard(RuntimeError):
    """The run needs more CUDA cards than this machine shows."""


def require_cards(torch, chips):
    """Raise :class:`NoCard` unless ``chips`` CUDA cards are present."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card is present (torch.cuda.is_available() "
                     "is False); the benchmark has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA cards, this machine has "
                     f"{torch.cuda.device_count()}")
