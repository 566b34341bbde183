"""2D tensor network compression (port of quimb_tpu's
``tensor/tn2d/compress.py``, reference ``quimb/tensor/tn2d/compress.py``).

The reference's 2D method table is empty and every method falls through
to the arbitrary-geometry compressions of ``tnag/``, which are not ported
yet: the dispatcher raises naming ROADMAP item 16.
"""

from ..core import _deferred


def tensor_network_2d_compress(tn, max_bond=None, cutoff=1e-10,
                               method="local-early", site_tags=None,
                               inplace=False, **kwargs):
    """Compress a 2D-like tensor network (reference
    ``tensor_network_2d_compress`` tn2d/compress.py:7): needs the
    arbitrary-geometry methods of ``tnag/``, not ported yet."""
    raise _deferred(16, "tensor_network_2d_compress (tnag/compress.py)")
