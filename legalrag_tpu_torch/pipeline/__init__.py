from legalrag_tpu_torch.pipeline.multistep import MultistepPipeline
from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline

__all__ = ["MultistepPipeline", "RagPipeline"]
