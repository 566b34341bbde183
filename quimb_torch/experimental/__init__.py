"""quimb_torch.experimental: the ported parts of quimb_tpu's
``experimental`` package (reference ``quimb/experimental/``). So far the
cluster update (``ClusterUpdateGen``, ``fit_bondenv_projectors``); VMC,
the autojit wrapper, the CP decomposition, the MERA builder, the marginals
and the other extras are not ported."""

from .cluster_update import ClusterUpdateGen, fit_bondenv_projectors

__all__ = ["ClusterUpdateGen", "fit_bondenv_projectors"]
