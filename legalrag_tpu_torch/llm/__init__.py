from legalrag_tpu_torch.llm.client import DEGRADED_ANSWER, LLMClient, LLMUnavailable
from legalrag_tpu_torch.llm.context import get_request_id, reset_request_id, set_request_id
from legalrag_tpu_torch.llm.gateway import LLMGateway

__all__ = ["DEGRADED_ANSWER", "LLMClient", "LLMGateway", "LLMUnavailable",
           "get_request_id", "reset_request_id", "set_request_id"]
