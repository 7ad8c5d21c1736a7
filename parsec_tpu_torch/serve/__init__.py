"""parsec_tpu_torch.serve — the multi-tenant serving plane.

The port of :mod:`parsec_tpu.serve`: one persistent
:class:`~parsec_tpu_torch.core.context.Context` admitting a stream of
taskpools from many tenants, with admission control, weighted fairness and
per-tenant observability.  See :mod:`parsec_tpu_torch.serve.service`.
"""

from .service import (
    AdmissionError,
    JobHandle,
    RuntimeService,
    Tenant,
    compose_priority,
    JOB_PRIORITY_SPAN,
    TASK_PRIORITY_SPAN,
)

__all__ = [
    "AdmissionError",
    "JobHandle",
    "RuntimeService",
    "Tenant",
    "compose_priority",
    "JOB_PRIORITY_SPAN",
    "TASK_PRIORITY_SPAN",
]
