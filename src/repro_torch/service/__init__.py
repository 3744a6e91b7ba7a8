# uops-as-a-service: turn exported machine-readable models (§6.4) into a
# queryable prediction backend — a model registry over XML artifacts, a
# vectorized batch predictor (numpy, or the port-bound CUDA kernel),
# an asyncio multi-worker front door with admission control, a sharded
# result cache, a negotiated binary/JSON wire, and a client + CLI.
from repro_torch.service.batch_predictor import BatchPredictor
from repro_torch.service.client import (ServiceClient, ServiceError,
                                  ServiceOverloaded, ServiceUnavailable,
                                  local_service)
from repro_torch.service.registry import (ModelNotFoundError, ModelRegistry,
                                    StaleModelError)
from repro_torch.service.server import (AdmissionController, PredictionServer,
                                  PredictionService,
                                  ThreadedPredictionServer)

__all__ = [
    "AdmissionController", "BatchPredictor", "ModelNotFoundError",
    "ModelRegistry", "PredictionServer", "PredictionService",
    "ServiceClient", "ServiceError", "ServiceOverloaded",
    "ServiceUnavailable", "StaleModelError", "ThreadedPredictionServer",
    "local_service",
]
