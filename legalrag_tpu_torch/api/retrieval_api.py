"""Standalone retrieval microservice (port of
``legalrag_tpu/api/retrieval_api.py``).

``POST /retrieve`` (route + hybrid search, hits as JSON) lets the main
server run retrieval in its own process or host (the split deployment of
``docker-compose.yml``): the main server calls it when the environment
variable ``RETRIEVAL_URL`` is set. Retrieval runs on ``cuda`` unless the
caller names another device.
"""

from __future__ import annotations

import time
from typing import Optional

from legalrag_tpu_torch.api.webcore import App, HTTPError, Request, Response
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline
from legalrag_tpu_torch.schemas import dump
from legalrag_tpu_torch.utils.device import DeviceLike


def create_app(cfg: Optional[AppConfig] = None,
               device: DeviceLike = None) -> App:
    cfg = cfg or AppConfig.load()
    app = App()
    pipeline = RagPipeline(cfg, device=device)

    @app.get("/health")
    def health(req: Request) -> Response:
        return Response({"status": "ok"})

    @app.post("/retrieve")
    def retrieve(req: Request) -> Response:
        body = req.json()
        question = (body.get("question") or "").strip()
        if not question:
            raise HTTPError(422, "question is required")
        hits, decision = pipeline.retrieve(question, top_k=body.get("top_k"))
        return Response({
            "question": question,
            "decision": dump(decision),
            "hits": [dump(h, exclude_none=True) for h in hits],
        })

    return app


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="legalrag_tpu_torch retrieval "
                                 "service")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the retrieval (default cuda)")
    args = ap.parse_args()
    cfg = AppConfig.load()
    app = create_app(cfg, device=args.device)
    app.serve(cfg.server.host, cfg.server.port)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
