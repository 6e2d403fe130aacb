"""Serving (port of vibevoice_tpu/serving): the continuous-batching
``ServingEngine`` of the multi-speaker model, the multi-session
``StreamingSessionEngine`` of the streaming 0.5B model
(``serving.streaming_sessions``) and the HTTP server (``serving.server``,
``python -m vibevoice_tpu_torch.serving.server``)."""

from .engine import EngineStats, Request, RequestHandle, ServingEngine

__all__ = ["ServingEngine", "Request", "RequestHandle", "EngineStats"]
