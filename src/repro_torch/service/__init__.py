"""The port's campaign service layer: for now the work-stealing scheduler
(:mod:`repro_torch.service.scheduler`) that the local
:class:`~repro_torch.core.campaign.CampaignRunner` drains its cell groups
through, inline or over a supervised pool of ``spawn`` workers.  The
HTTP server, its client and the global store are not ported yet.
"""
from .scheduler import Scheduler, SchedulerConfig, WorkUnit, run_groups_local

__all__ = [
    "Scheduler",
    "SchedulerConfig",
    "WorkUnit",
    "run_groups_local",
]
