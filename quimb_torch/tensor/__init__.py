"""Tensor-network algorithms of quimb_torch."""

from .tn1d import *  # noqa: F401,F403
from .tn1d import __all__  # noqa: F401
