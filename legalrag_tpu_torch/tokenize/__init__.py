from legalrag_tpu_torch.tokenize.tokenizers import (
    char_ngrams,
    fnv1a,
    hash_features,
    secrefs_en,
    tokenize,
    tokenize_en,
    tokenize_zh,
)

__all__ = ["char_ngrams", "fnv1a", "hash_features", "secrefs_en", "tokenize",
           "tokenize_en", "tokenize_zh"]
