from legalrag_tpu_torch.graph.builder import GraphBuilder
from legalrag_tpu_torch.graph.store import LawGraphStore

__all__ = ["GraphBuilder", "LawGraphStore"]
