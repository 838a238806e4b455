"""Index-registry microservice (port of ``legalrag_tpu/api/index_api.py``).

``GET /index/active``, ``GET /index/list`` and ``POST
/index/activate/{version}`` (404 for a version that is not there), for the
language of the ``lang`` query parameter (the config's language by
default), over ``paths.index_dir/<lang>`` (``index/registry.py``). Host
code: it reads and writes the ``ACTIVE`` pointer and touches no device. A
serving process picks an activated version up when its manifest
generation is above the one it serves (``retrieval/by_lang.py``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

from legalrag_tpu_torch.api.webcore import App, HTTPError, Request, Response
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.registry import IndexRegistry


def create_app(cfg: Optional[AppConfig] = None) -> App:
    cfg = cfg or AppConfig.load()
    app = App()

    def registry(req: Request) -> IndexRegistry:
        lang = req.query.get("lang", cfg.lang)
        return IndexRegistry(Path(cfg.paths.index_dir) / lang)

    @app.get("/index/active")
    def active(req: Request) -> Response:
        r = registry(req)
        return Response({"active_version": r.active_version(),
                         "active_dir": str(r.active_index_dir())})

    @app.get("/index/list")
    def list_versions(req: Request) -> Response:
        return Response({"versions": registry(req).list_versions()})

    @app.post("/index/activate/{version}")
    def activate(req: Request) -> Response:
        try:
            target = registry(req).activate(req.params["version"])
        except FileNotFoundError as e:
            raise HTTPError(404, str(e))
        return Response({"activated": req.params["version"],
                         "dir": str(target)})

    return app


def main() -> None:
    cfg = AppConfig.load()
    create_app(cfg).serve(cfg.server.host, cfg.server.port)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
