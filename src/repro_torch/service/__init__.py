"""The port's campaign service: multi-tenant DSE serving (README "Campaign
service"), with the JAX package's layers and names.

A shared content-addressed cell store with cross-campaign/cross-tenant
dedup (:mod:`repro_torch.service.store`), a work-stealing fair-share
scheduler with worker supervision over ``spawn`` workers
(:mod:`repro_torch.service.scheduler`), an HTTP/JSON server with streaming
progress and live metrics whose cells run on one server-wide device
(:mod:`repro_torch.service.server`), and a stdlib client
(:mod:`repro_torch.service.client`).

`python -m repro_torch campaign serve` / `campaign submit --url ...` are
the CLI entrypoints; the local
:class:`~repro_torch.core.campaign.CampaignRunner` drives the same
scheduler in-process, so local and served campaigns are bit-identical.
"""
from .client import ServiceClient, ServiceError
from .scheduler import Scheduler, SchedulerConfig, WorkUnit, run_groups_local
from .server import CampaignService, QueueSaturated, make_server, serve
from .store import DEFAULT_SERVICE_ROOT, CampaignView, GlobalStore

__all__ = [
    "CampaignService",
    "CampaignView",
    "DEFAULT_SERVICE_ROOT",
    "GlobalStore",
    "QueueSaturated",
    "Scheduler",
    "SchedulerConfig",
    "ServiceClient",
    "ServiceError",
    "WorkUnit",
    "make_server",
    "run_groups_local",
    "serve",
]
