from legalrag_tpu_torch.evals.metrics import (
    aggregate,
    evaluate_one,
    hit_at_k,
    mrr_at_k,
    ndcg_at_k,
    recall_at_k,
)

__all__ = ["aggregate", "evaluate_one", "hit_at_k", "mrr_at_k", "ndcg_at_k",
           "recall_at_k"]
