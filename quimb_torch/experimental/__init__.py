"""quimb_torch.experimental: VMC, the autojit decorator, cluster updates,
the CP decomposition, network marginals, the isometric network builder and
other extras; the port of quimb_tpu's ``experimental`` package (reference
``quimb/experimental/``)."""

from .cluster_update import ClusterUpdateGen, fit_bondenv_projectors
from .merabuilder import TensorNetworkGenIso, TTN_randtree_rand
from .cp_decomp import cp_decompose, cp_simplify
from .tn_marginals import (
    compute_all_marginals_via_autodiff,
    compute_all_marginals_via_slicing,
)
from .tnvmc import (
    AmplitudeFactory,
    BPSampler,
    ClusterSampler,
    DenseSampler,
    ExchangeSampler,
    HamiltonianSampler,
    MetropolisHastingsSampler,
    TNVMC,
)
from .autojittn import autojit_tn
from .misc import (
    classical_ising_T_A_C,
    ctmrg_partition_function,
    product_expectation_cluster,
    product_expectation_exact,
    virtual_bond_operator,
    virtual_site_operator,
)

__all__ = [
    "ClusterUpdateGen",
    "TensorNetworkGenIso",
    "TTN_randtree_rand",
    "fit_bondenv_projectors",
    "cp_decompose",
    "cp_simplify",
    "compute_all_marginals_via_autodiff",
    "compute_all_marginals_via_slicing",
    "TNVMC",
    "MetropolisHastingsSampler",
    "ExchangeSampler",
    "HamiltonianSampler",
    "DenseSampler",
    "ClusterSampler",
    "BPSampler",
    "AmplitudeFactory",
    "autojit_tn",
    "classical_ising_T_A_C",
    "ctmrg_partition_function",
    "product_expectation_cluster",
    "product_expectation_exact",
    "virtual_bond_operator",
    "virtual_site_operator",
]
