from legalrag_tpu_torch.ingest.ingestor import PDFIngestor, compute_doc_id
from legalrag_tpu_torch.ingest.orchestrator import IngestOrchestrator
from legalrag_tpu_torch.ingest.service import IngestService
from legalrag_tpu_torch.ingest.task_queue import TaskQueue

__all__ = ["IngestOrchestrator", "IngestService", "PDFIngestor", "TaskQueue",
           "compute_doc_id"]
