from legalrag_tpu_torch.api.webcore import (
    App,
    HTTPError,
    Request,
    Response,
    StreamingResponse,
    TestClient,
    sse_event,
)

__all__ = ["App", "HTTPError", "Request", "Response", "StreamingResponse",
           "TestClient", "sse_event"]
