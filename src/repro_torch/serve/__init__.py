"""Batched serving (port of ``repro.serve``)."""
from repro_torch.serve.engine import (AdmissionConfig, LENGTH_CLASS, Request,
                                      ServeEngine)

__all__ = ["ServeEngine", "Request", "AdmissionConfig", "LENGTH_CLASS"]
