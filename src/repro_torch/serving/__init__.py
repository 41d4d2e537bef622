"""Serving runtime of the port: paged KV manager, engine, frontend,
cluster, and the HTTP/SSE gateway (its entry points exported here)."""
from repro_torch.serving.gateway import (SLO_CLASSES, GatewayClientError,
                                         GatewayHandle, PayloadError,
                                         SSEGateway, collect_stream,
                                         http_get, http_post, open_sse,
                                         request_from_payload, run_in_thread,
                                         sse_events)

__all__ = [
    "SLO_CLASSES", "GatewayClientError", "GatewayHandle", "PayloadError",
    "SSEGateway", "collect_stream", "http_get", "http_post", "open_sse",
    "request_from_payload", "run_in_thread", "sse_events",
]
