"""Serving tier of the PyTorch port (port of ``serving/``; reference
layer 9: the dedicated model-server split — continuous-batching engine,
autoregressive generation front-end, replicated fleet front with
affinity routing + tenant quotas + canary promotion, nearest-neighbors
REST server, streaming predict routes)."""
from .engine import (AdmissionController, GenerationClient, SLOConfig,
                     ServingClient, ServingEngine, ServingServer, ShedError)
from .fleet import (CanaryConfig, CanaryController, FleetClient,
                    FleetConfig, FleetRouter, FleetServer, ServingFleet)
from .inference_server import InferenceClient, InferenceServer
from .nn_server import NearestNeighborsClient, NearestNeighborsServer
from .tenancy import TenantAdmission, TenantQuota, tenant_label

__all__ = ["NearestNeighborsServer", "NearestNeighborsClient",
           "InferenceServer", "InferenceClient",
           "ServingEngine", "ServingServer", "ServingClient",
           "GenerationClient", "AdmissionController", "SLOConfig",
           "ShedError", "TenantAdmission", "TenantQuota", "tenant_label",
           "ServingFleet", "FleetRouter", "FleetConfig",
           "FleetServer", "FleetClient",
           "CanaryController", "CanaryConfig"]
