from legalrag_tpu_torch.agents.legal_agent import LegalAgent

__all__ = ["LegalAgent"]
