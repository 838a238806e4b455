"""Ingest service: upload -> extract -> background indexing (port of
``legalrag_tpu/ingest/service.py``).

Saves the upload under ``paths.upload_dir``, extracts and chunks it to
JSONL in the request (``PDFIngestor``), sets the document's status, and
queues the index and graph jobs on one background worker (``TaskQueue``).
The jobs grow the bundles of the ``BundleCache`` that the server's
retriever reads, on that cache's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.ingest.ingestor import PDFIngestor
from legalrag_tpu_torch.ingest.orchestrator import IngestOrchestrator
from legalrag_tpu_torch.ingest.task_queue import TaskQueue
from legalrag_tpu_torch.retrieval.by_lang import BundleCache


class IngestService:
    def __init__(self, cfg: AppConfig, cache: BundleCache):
        self.cfg = cfg
        self.ingestor = PDFIngestor(cfg)
        self.orchestrator = IngestOrchestrator(cfg, cache)
        self.queue = TaskQueue("ingest")

    def ingest_upload_and_schedule(self, filename: str, content: bytes
                                   ) -> Tuple[str, int]:
        """(doc_id, number of chunks); raises ``ValueError`` or
        ``RuntimeError`` when no text can be extracted."""
        upload_dir = Path(self.cfg.paths.upload_dir)
        upload_dir.mkdir(parents=True, exist_ok=True)
        safe = Path(filename).name or "upload.bin"
        path = upload_dir / safe
        path.write_bytes(content)
        doc_id, _out, chunks = self.ingestor.ingest_file_to_jsonl(path, safe)
        self.orchestrator.init_status(doc_id)
        self.queue.enqueue(self.orchestrator.index_job, doc_id, chunks)
        self.queue.enqueue(self.orchestrator.graph_job, doc_id)
        return doc_id, len(chunks)

    def get_status(self, doc_id: str) -> Dict[str, str]:
        return self.orchestrator.get_status(doc_id)
