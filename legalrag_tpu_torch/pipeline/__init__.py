from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline

__all__ = ["RagPipeline"]
