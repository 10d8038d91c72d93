"""qkd_ldpc_v_tpu_torch — the PyTorch and CUDA port of qkd_ldpc_v_tpu.

QKD LDPC information reconciliation on an NVIDIA H100: the fixed-rate
Monte-Carlo sweep over quasi-cyclic codes with the min-sum decoders
(NMSA, OMSA, ANMSA, AOMSA), flooding or layered, through a hand-written
fused QC decoder kernel (``csrc/fused_qc.cu``). CPU tensors run the
kernel's plain torch version. The JAX package ``qkd_ldpc_v_tpu`` is the
reference this package is tested against; this package never imports it
or JAX.
"""

__version__ = "0.1.0"

from qkd_ldpc_v_tpu_torch.config import (  # noqa: F401
    Config,
    DecodingAlgorithm,
    MatrixFormat,
    parse_config_data,
)
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix, read_matrix  # noqa: F401
from qkd_ldpc_v_tpu_torch.models.qc import (  # noqa: F401
    QCMatrix,
    generate_qc_ldpc,
    generate_qc_peg,
    read_qc_matrix,
)
from qkd_ldpc_v_tpu_torch.simulation import (  # noqa: F401
    SimResult,
    prepare_sim_inputs,
    qkd_ldpc_batch_simulation,
    run_combination,
    write_file,
)
