"""Whole-network function decoration (reference
``quimb/experimental/autojittn.py:21``).

quimb_tpu's ``autojit_tn`` wraps a function of a tensor network in
``jax.jit``. The port keeps the decorator's API with an eager default:
``decorator`` is the identity, so the function runs op by op on the
tensors' device. Any other decorator (``torch.compile`` among them) can
be passed; none is the default, since no measurement has shown one to
help."""

import functools

__all__ = ["autojit_tn"]


def _identity(fn, **_):
    return fn


def autojit_tn(fn=None, decorator=_identity, check_inputs=True, **jit_opts):
    """Decorate ``fn(tn, *args) -> array`` with ``decorator(fn,
    **jit_opts)`` (eager by default)."""
    if fn is None:
        return functools.partial(
            autojit_tn, decorator=decorator, check_inputs=check_inputs,
            **jit_opts,
        )

    jitted = decorator(fn, **jit_opts)

    @functools.wraps(fn)
    def wrapper(tn, *args, **kwargs):
        return jitted(tn, *args, **kwargs)

    wrapper.__wrapped__ = fn
    return wrapper
