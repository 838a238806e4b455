"""LegalAgent: the user-facing agent facade (port of
``legalrag_tpu/agents/legal_agent.py:24-44``).

``answer`` runs the single-pass RAG flow; ``answer_complex`` runs
decompose -> retrieve per step -> synthesize through
``MultistepPipeline``; ``answer_auto`` escalates to the latter when the
decomposition finds more than one sub-question. Without a ``pipeline``
the agent builds one on ``device`` (``cuda`` by default, which raises
without a card).
"""

from __future__ import annotations

from typing import Optional

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.pipeline.multistep import MultistepPipeline
from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline
from legalrag_tpu_torch.schemas import RagAnswer
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import DeviceLike

log = get_logger("torch.legal_agent")


class LegalAgent:
    def __init__(self, cfg: Optional[AppConfig] = None,
                 pipeline: Optional[RagPipeline] = None, max_steps: int = 4,
                 device: DeviceLike = None):
        self.cfg = cfg or AppConfig.load()
        self.pipeline = pipeline or RagPipeline(self.cfg, device=device)
        self.multistep = MultistepPipeline(self.pipeline, max_steps=max_steps)

    def answer(self, question: str, top_k: Optional[int] = None) -> RagAnswer:
        return self.pipeline.answer(question, top_k=top_k)

    def answer_complex(self, question: str) -> RagAnswer:
        return self.multistep.answer_complex(question)

    def answer_auto(self, question: str) -> RagAnswer:
        """Escalate to multistep when decomposition finds >1 sub-question."""
        subs = self.multistep.decompose(question)
        if len(subs) > 1:
            log.info("multi-part question (%d sub-questions); multistep flow",
                     len(subs))
            return self.answer_complex(question)
        return self.answer(question)
