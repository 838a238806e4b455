from legalrag_tpu_torch.utils.lang import detect_lang, has_chinese
from legalrag_tpu_torch.utils.logger import get_logger

__all__ = ["detect_lang", "has_chinese", "get_logger"]
