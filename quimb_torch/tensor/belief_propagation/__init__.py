"""Belief propagation on tensor networks.

Re-design of reference ``quimb/tensor/belief_propagation/`` (taxonomy
documented at its ``__init__.py:1-80``):

- D1BP (dense, 1-norm): messages on the bonds of a closed TN —
  estimates the contracted value (partition functions, amplitudes).
- D2BP (dense, 2-norm): messages on the bonds of a TN *vector* in the
  sandwiched <psi|psi> network — local expectations, compression and
  gauging of PEPS-like states.
- HV1BP (hyper, vectorized): 1-norm BP with all same-shape message
  updates batched into single array ops (the reference notes this is
  'enormously more efficient' for many small tensors): one batched
  ``torch.einsum`` per leg of each group of same-shape tensors.

Port of quimb_tpu's ``tensor/belief_propagation/``, with MPS1BP, the lazy
L1BP / L2BP, DIIS, region graphs and generalized BP (HD1GBP).
"""

from .bp_common import (
    BeliefPropagationCommon,
    combine_local_contractions,
    initialize_hyper_messages,
    initialize_messages,
)
from .d1bp import D1BP, contract_d1bp, contract_hd1bp, sample_hd1bp
from .d2bp import D2BP, compress_d2bp, contract_d2bp, gauge_d2bp, sample_d2bp
from .hv1bp import HV1BP, contract_hv1bp, sample_hv1bp

__all__ = [
    "BeliefPropagationCommon",
    "initialize_messages",
    "D1BP",
    "contract_d1bp",
    "D2BP",
    "compress_d2bp",
    "contract_d2bp",
    "gauge_d2bp",
    "HV1BP",
    "contract_hv1bp",
    "combine_local_contractions",
    "initialize_hyper_messages",
    "contract_hd1bp",
    "sample_hd1bp",
    "sample_d2bp",
    "sample_hv1bp",
    "compress_l2bp",
    "gen_region_counts",
]

from .extras import (
    DIIS,
    HD1BP,
    L1BP,
    L2BP,
    RegionGraph,
    compress_l2bp,
    contract_l1bp,
    contract_l2bp,
    gen_region_counts,
)
from .gbp import HD1GBP, contract_hd1gbp
from .mps1bp import MPS1BP, contract_mps1bp

__all__ += [
    "HD1GBP",
    "contract_hd1gbp",
    "MPS1BP",
    "contract_mps1bp",
    "DIIS", "HD1BP", "L1BP", "L2BP", "RegionGraph", "contract_l1bp",
    "contract_l2bp",
]
