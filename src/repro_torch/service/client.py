"""HTTP client for the campaign service (stdlib ``urllib`` only).

    from repro_torch.service import ServiceClient
    client = ServiceClient("http://127.0.0.1:8321")
    sub = client.submit(campaign.to_json(), tenant="alice")
    for event in client.events(sub["submission_id"]):
        print(event["type"], event.get("tag", ""))
    report = client.wait(sub["submission_id"])["report"]

Used by ``python -m repro_torch campaign submit --url ...`` and by the chaos
harness; nothing here imports the heavy core, so a thin submit-only
client stays cheap.

Resilience: every request retries transient failures (connection
refused/reset, 5xx, and 429 — honouring its ``Retry-After`` hint) with
jittered, bounded exponential backoff.  Retrying ``POST /campaigns`` is
safe because submission is idempotent per ``(tenant, campaign_id)`` —
a resubmission is a resume.  :meth:`events` survives dropped streams by
reconnecting with ``?since=<cursor>``, so no event is ever lost or
duplicated across reconnects.  Exhausted retries raise
:class:`ServiceError` with ``retryable`` set, which the CLI maps to a
distinct exit code.
"""
from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional

from .. import faults

__all__ = ["ServiceClient", "ServiceError"]

#: HTTP codes worth retrying: the service is alive but momentarily
#: unable (429 backpressure) or broken behind a proxy (5xx).
RETRYABLE_CODES = frozenset({429, 500, 502, 503, 504})


class ServiceError(RuntimeError):
    """An HTTP-level failure talking to the campaign service.

    ``retryable`` distinguishes "try again later" failures (queue
    saturation, connection loss, 5xx — the client already retried
    ``retries`` times before raising) from permanent ones (4xx)."""

    def __init__(self, code: int, message: str, *, retryable: bool = False) -> None:
        super().__init__(f"HTTP {code}: {message}")
        self.code = code
        self.retryable = retryable


class ServiceClient:
    def __init__(
        self,
        base_url: str,
        *,
        timeout_s: float = 30.0,
        retries: int = 3,
        backoff_base_s: float = 0.25,
        backoff_max_s: float = 5.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.retries = max(0, retries)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._rng = random.Random()

    # ------------------------------------------------------------- plumbing
    def _backoff(self, attempt: int, retry_after_s: Optional[float] = None) -> None:
        """Sleep before retry ``attempt`` (1-based): the server's
        ``Retry-After`` hint when given, else jittered exponential
        backoff, both capped at ``backoff_max_s``."""
        if retry_after_s is not None:
            delay = min(max(retry_after_s, 0.0), self.backoff_max_s)
        else:
            delay = min(
                self.backoff_base_s * 2 ** (attempt - 1), self.backoff_max_s
            )
        # Full jitter keeps a fleet of retrying clients from thundering
        # back in lockstep.
        time.sleep(delay * (0.5 + 0.5 * self._rng.random()))

    def _request(self, path: str, body: Optional[Dict[str, Any]] = None) -> Any:
        data = None if body is None else json.dumps(body).encode()
        last: Optional[ServiceError] = None
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(
                self.base_url + path,
                data=data,
                headers={"Content-Type": "application/json"} if data else {},
                method="POST" if data is not None else "GET",
            )
            retry_after: Optional[float] = None
            try:
                if faults.fire("http.client", path=path) == "reset":
                    raise urllib.error.URLError(
                        ConnectionResetError("injected connection reset")
                    )
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    return json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                try:
                    message = json.loads(e.read().decode()).get("error", str(e))
                except Exception:
                    message = str(e)
                if e.code not in RETRYABLE_CODES:
                    raise ServiceError(e.code, message) from None
                try:
                    header = e.headers.get("Retry-After") if e.headers else None
                    retry_after = float(header) if header else None
                except (TypeError, ValueError):
                    retry_after = None
                last = ServiceError(e.code, message, retryable=True)
            except urllib.error.URLError as e:
                last = ServiceError(
                    0, f"cannot reach {self.base_url}: {e.reason}",
                    retryable=True,
                )
            except (ConnectionError, TimeoutError, OSError) as e:
                # Mid-body failures surface raw (the stream broke after
                # urlopen succeeded), not wrapped in URLError.
                last = ServiceError(
                    0, f"connection to {self.base_url} failed: {e}",
                    retryable=True,
                )
            if attempt < self.retries:
                self._backoff(attempt + 1, retry_after)
        assert last is not None
        raise last from None

    # ------------------------------------------------------------------ api
    def healthz(self) -> Dict[str, Any]:
        return self._request("/healthz")

    def submit(
        self,
        campaign_spec: Dict[str, Any],
        *,
        tenant: str = "default",
        priority: int = 0,
    ) -> Dict[str, Any]:
        return self._request(
            "/campaigns",
            {"campaign": campaign_spec, "tenant": tenant, "priority": priority},
        )

    def submissions(self) -> List[str]:
        return self._request("/campaigns")["submissions"]

    def status(self, submission_id: str) -> Dict[str, Any]:
        return self._request(f"/campaigns/{submission_id}")

    def metrics(self) -> Dict[str, Any]:
        return self._request("/metrics")

    def metrics_text(self) -> str:
        """The Prometheus text exposition of ``/metrics`` (same values as
        the JSON endpoint, negotiated via ``Accept: text/plain``)."""
        req = urllib.request.Request(
            self.base_url + "/metrics", headers={"Accept": "text/plain"}
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.read().decode()
        except urllib.error.HTTPError as e:
            raise ServiceError(e.code, str(e)) from None
        except urllib.error.URLError as e:
            raise ServiceError(0, f"cannot reach {self.base_url}: {e.reason}") from None

    def events(
        self, submission_id: str, *, since: int = 0
    ) -> Iterator[Dict[str, Any]]:
        """Stream per-cell progress as parsed JSON-lines events until the
        campaign finishes (the terminal ``stream_end`` line is consumed,
        not yielded).

        A dropped stream (reset, timeout, server restart) reconnects with
        ``?since=<cursor>`` where the cursor counts events already
        yielded — exactly-once delivery across reconnects.  Progress
        resets the attempt budget; ``retries`` consecutive dead
        reconnects raise the last error."""
        cursor = since
        failures = 0
        while True:
            made_progress = False
            try:
                req = urllib.request.Request(
                    f"{self.base_url}/campaigns/{submission_id}/events"
                    f"?since={cursor}"
                )
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    if resp.status != 200:
                        raise ServiceError(resp.status, resp.read().decode()[:200])
                    for line in resp:
                        line = line.strip()
                        if not line:
                            continue
                        event = json.loads(line.decode())
                        if event.get("type") == "stream_end":
                            return
                        cursor += 1
                        made_progress = True
                        failures = 0
                        yield event
                # Clean EOF without stream_end: the connection closed
                # mid-stream (server restart); fall through to reconnect.
            except urllib.error.HTTPError as e:
                if e.code not in RETRYABLE_CODES:
                    raise ServiceError(e.code, str(e)) from None
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError, ValueError):
                pass  # reconnect below
            if not made_progress:
                failures += 1
                if failures > self.retries:
                    raise ServiceError(
                        0,
                        f"event stream for {submission_id} died after "
                        f"{failures} reconnect attempts (cursor={cursor})",
                        retryable=True,
                    )
            self._backoff(max(failures, 1))

    def wait(
        self,
        submission_id: str,
        *,
        timeout_s: Optional[float] = None,
        poll_s: float = 0.2,
    ) -> Dict[str, Any]:
        """Poll ``status`` until the campaign is done; returns the final
        status (with its full incremental report)."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            status = self.status(submission_id)
            if status["done"]:
                return status
            sched = status.get("scheduler") or {}
            if sched.get("errors"):
                return status  # failed units will never complete; stop polling
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"campaign {submission_id} not done after {timeout_s}s"
                )
            time.sleep(poll_s)
