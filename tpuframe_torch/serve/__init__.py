"""Serving: admission, SLO plane, the batching engine and its HTTP front."""

from tpuframe_torch.serve.admission import (
    AdmissionController,
    InvalidRequest,
    RequestRejected,
    RequestShed,
    ServeKnobs,
    validate_payload,
)
from tpuframe_torch.serve.engine import ServeEngine, ServeResult
from tpuframe_torch.serve.server import ServingServer
from tpuframe_torch.serve.slo import SloObjectives, SloTracker

__all__ = [
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
    "validate_payload",
]
