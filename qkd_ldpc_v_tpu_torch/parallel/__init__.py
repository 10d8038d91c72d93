"""Distribution layer: the Monte-Carlo frames of each chunk split over the
ranks of a ``torch.distributed`` group, one rank per device.

Counterpart of ``qkd_ldpc_v_tpu/parallel``. The reference's only
parallelism is a shared-memory thread pool over trials (reference:
src/simulation.cpp:721, 740-746). Here each rank decodes its share of
every chunk through the same kernels as a single-rank run, and statistics
are gathered per frame or reduced on the device with collectives.
"""

from qkd_ldpc_v_tpu_torch.parallel.driver import (  # noqa: F401
    DataMesh,
    edge_sharded_decoder,
    initialize_distributed,
    make_data_mesh,
    mesh_step_factory,
    psum_stats,
    sharded_step,
)
