"""Default dtypes and the precision contract of quimb_torch.

quimb_tpu runs every float32 matrix product at full float32 precision
(``jax_default_matmul_precision="highest"``). The port keeps that
contract: TF32 is switched off for cuBLAS and cuDNN, once, when the
package is imported.
"""

import torch

#: dtype of operators built without an explicit one (dropped to the real
#: counterpart when the operator is real, as in quimb_tpu)
DEFAULT_DTYPE = torch.complex128
#: dtype of random states built without an explicit one
DEFAULT_REAL_DTYPE = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
