"""repro_torch.obs — unified telemetry: structured spans, counters, namespaced
logging, Chrome-trace/Perfetto export, and Prometheus text exposition.

Quick start::

    from repro_torch import obs

    with obs.span("engine.decode", decoder="caps_hms") as sp:
        ...
        sp.set(feasible=True)
    obs.counter_add("engine.cache_hits", 3)
    obs.event("service.claim_contention", spec=h, owner=owner)

Disabled by default; set ``REPRO_OBS=1`` (sinks under ``runs/obs/``) or
``REPRO_OBS=<dir>`` to record.  Export with ``python -m repro_torch trace
export``; aggregate with ``python -m repro_torch trace summary``.
"""
from .logs import (  # noqa: F401
    LOG_LEVEL_ENV,
    SERVICE_LOG_ENV,
    access_log_enabled,
    get_logger,
)
from .prom import PROM_CONTENT_TYPE, prometheus_text  # noqa: F401
from .recorder import (  # noqa: F401
    OBS_DIR_ENV,
    OBS_ENV,
    configure,
    counter_add,
    default_obs_dir,
    enabled,
    event,
    flush,
    iter_records,
    set_process_name,
    shutdown,
    span,
)
from .trace import (  # noqa: F401
    export_chrome_trace,
    format_summary,
    summarize,
    validate_chrome_trace,
)

__all__ = [
    "span",
    "event",
    "counter_add",
    "enabled",
    "configure",
    "flush",
    "shutdown",
    "set_process_name",
    "default_obs_dir",
    "iter_records",
    "get_logger",
    "access_log_enabled",
    "prometheus_text",
    "PROM_CONTENT_TYPE",
    "export_chrome_trace",
    "validate_chrome_trace",
    "summarize",
    "format_summary",
    "OBS_ENV",
    "OBS_DIR_ENV",
    "LOG_LEVEL_ENV",
    "SERVICE_LOG_ENV",
]
