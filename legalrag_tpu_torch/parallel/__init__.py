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
from legalrag_tpu_torch.parallel.decoder_tp import (
    TPDecoderModel,
    apply_tp_to_engine,
    shard_decoder_params,
    tp_kv_cache_sharding,
)
from legalrag_tpu_torch.parallel.decoder_dp import DPDecoderRouter

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "DPDecoderRouter", "Mesh", "TPDecoderModel",
    "apply_tp_to_engine", "batch_sharded", "local_devices", "make_mesh",
    "replicated", "row_sharded", "shard_decoder_params",
    "tp_kv_cache_sharding",
]
