"""qkd_ldpc_v_tpu_torch — the PyTorch and CUDA port of qkd_ldpc_v_tpu.

QKD LDPC information reconciliation on an NVIDIA H100: the Monte-Carlo
sweep (fixed rate and rate-adaptive, with privacy maintenance) over codes
in all five matrix formats (alist, format 1, format 2, dense,
quasi-cyclic), resumable from a per-combination checkpoint, and the
single-round library API that a QKD stack calls on each block of sifted
key (``make_protocol_spec``, ``qkd_ldpc``, ``qkd_ldpc_rate_adapt``). All six
algorithms (SPA, SPA-lin-approx, NMSA, OMSA, ANMSA, AOMSA) run through four
hand-written kernels: the fused QC decoder (``csrc/fused_qc.cu``, flooding
or layered), the streamed QC decoder for QC codes too large for it, such as
the N=102400 codes (``csrc/qc_stream.cu``, flooding or layered), the fused
generic decoder for arbitrary sparse codes (``csrc/fused_generic.cu``,
flooding) and the streamed generic decoder for those too large for it,
such as the N=102400 alist code (``csrc/generic_stream.cu``, flooding).
The library rounds decode with the two generic kernels, as the JAX
package's rounds take its generic decoder. The generic torch decoder
(``ops/decoders.py``) runs in float32, float64 or bfloat16 when
``tpu.use_pallas`` is false. A sweep splits over the ranks of a
``torch.distributed`` group, one rank per device (``parallel``:
``mesh_step_factory`` as the sweep's ``step_factory``, statistics gathered
per frame or reduced on the device, and the edge-sharded generic decoder).
Traced runs decode on the host through the
float64 oracle (``oracle.py``, ``tracing.py``). CPU tensors run the
kernels' plain torch versions. The JAX package ``qkd_ldpc_v_tpu`` is the
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
from qkd_ldpc_v_tpu_torch.models.layout import EdgeLayout, compile_layout  # noqa: F401
from qkd_ldpc_v_tpu_torch.models.qc import (  # noqa: F401
    QCMatrix,
    generate_qc_ldpc,
    generate_qc_peg,
    read_qc_matrix,
    write_qc_matrix,
)
from qkd_ldpc_v_tpu_torch.protocol import (  # noqa: F401
    ProtocolResult,
    ProtocolSpec,
    make_protocol_spec,
    qkd_ldpc,
    qkd_ldpc_rate_adapt,
)
from qkd_ldpc_v_tpu_torch.simulation import (  # noqa: F401
    SimResult,
    prepare_sim_inputs,
    qc_kernel,
    qkd_ldpc_batch_simulation,
    run_combination,
    select_engine,
    write_file,
)
