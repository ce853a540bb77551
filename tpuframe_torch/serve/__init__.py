"""Serving: admission, SLO plane, the batching engine and its HTTP front."""

from tpuframe_torch.serve.admission import (
    SERVE_ENV_VARS,
    AdmissionController,
    InvalidRequest,
    RequestRejected,
    RequestShed,
    ServeKnobs,
    read_export_meta,
    sanitize_trace_id,
    validate_payload,
)
from tpuframe_torch.serve.engine import ServeEngine, ServeResult
from tpuframe_torch.serve.server import ServingServer
from tpuframe_torch.serve.slo import SloObjectives, SloTracker

__all__ = [
    "SERVE_ENV_VARS",
    "AdmissionController",
    "InvalidRequest",
    "RequestRejected",
    "RequestShed",
    "ServeEngine",
    "ServeKnobs",
    "ServeResult",
    "ServingServer",
    "SloObjectives",
    "SloTracker",
    "read_export_meta",
    "sanitize_trace_id",
    "validate_payload",
]
