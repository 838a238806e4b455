from legalrag_tpu_torch.routing.issue_extractor import (
    IssueResult,
    LegalIssueExtractor,
    has_article_ref,
)
from legalrag_tpu_torch.routing.router import QueryRouter

__all__ = ["IssueResult", "LegalIssueExtractor", "QueryRouter",
           "has_article_ref"]
