"""2D tensor network compression (port of quimb_tpu's
``tensor/tn2d/compress.py``, reference ``quimb/tensor/tn2d/compress.py``).

The reference's table of 2D-specific methods is empty, and every method
falls through to ``tensor_network_ag_compress`` (tn2d/compress.py:78): the
arbitrary-geometry compressions of :mod:`quimb_torch.tensor.tnag.compress`.
"""

from ..tnag.compress import tensor_network_ag_compress


def tensor_network_2d_compress(
    tn,
    max_bond=None,
    cutoff=1e-10,
    method="local-early",
    site_tags=None,
    inplace=False,
    **kwargs,
):
    """Compress a 2D-like tensor network (reference
    ``tensor_network_2d_compress`` tn2d/compress.py:7) by one of the
    arbitrary-geometry methods ("local-early", "local-late",
    "superorthogonal", "projector"); ``site_tags`` is accepted for the
    reference's 2D methods, of which there are none."""
    return tensor_network_ag_compress(
        tn, max_bond=max_bond, cutoff=cutoff, method=method,
        inplace=inplace, **kwargs,
    )
