from legalrag_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharded,
    local_devices,
    make_mesh,
    replicated,
    row_sharded,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "batch_sharded", "local_devices",
    "make_mesh", "replicated", "row_sharded",
]
