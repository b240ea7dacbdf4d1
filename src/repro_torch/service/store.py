"""Cross-campaign, cross-tenant artifact store for the campaign service.

A :class:`GlobalStore` layers the service's dedup policy over the plain
per-campaign :class:`~repro_torch.core.runstore.RunStore` layout:

    <root>/
      global/
        cells/<spec_hash>.json     one artifact per unique cell spec hash,
        claims/<spec_hash>.claim   shared by every campaign and tenant
      campaigns/<submission_id>/
        manifest.json              per-submission manifest + report — the
        report.json                same files a local CampaignRunner writes

Cell spec hashes are content addresses (canonical JSON of everything that
determines the result — see :meth:`CampaignCell.spec_hash`), so two
campaigns, two tenants, or two re-submissions that expand to the same
cell share one artifact: the first worker to claim the hash decodes it,
everyone else gets a dedup hit.  The claim protocol (``O_CREAT|O_EXCL``
claim files with heartbeat mtimes, :meth:`RunStore.claim`) guarantees the
"decoded exactly once" half; atomic ``os.replace`` writes guarantee the
"never torn" half.

A :class:`CampaignView` is what a submission's runner/report code sees:
it *is* a ``RunStore`` rooted at the submission directory (manifest and
report land there), but every cell operation is delegated to the global
cell store.  ``build_report`` and ``CampaignRunner`` work against a view
unchanged — which is exactly how served campaigns stay bit-identical to
local runs.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from ..core.runstore import MANIFEST, RunStore

__all__ = ["GlobalStore", "CampaignView", "DEFAULT_SERVICE_ROOT"]

DEFAULT_SERVICE_ROOT = os.path.join("runs", "service")
GLOBAL_DIR = "global"
CAMPAIGN_DIR = "campaigns"


class CampaignView(RunStore):
    """A submission's window onto the shared store: per-submission
    manifest/report, globally deduped cells and claims."""

    def __init__(self, global_store: "GlobalStore", submission_id: str) -> None:
        super().__init__(os.path.join(global_store.root, CAMPAIGN_DIR, submission_id))
        self.global_store = global_store
        self.submission_id = submission_id

    # Everything cell- or claim-shaped goes to the shared store.
    def cell_path(self, spec_hash: str) -> str:
        return self.global_store.cells.cell_path(spec_hash)

    def claim_path(self, spec_hash: str) -> str:
        return self.global_store.cells.claim_path(spec_hash)

    def has_cell(self, spec_hash: str) -> bool:
        return self.global_store.cells.has_cell(spec_hash)

    def save_cell(self, spec_hash: str, payload: Dict[str, Any]) -> str:
        return self.global_store.cells.save_cell(spec_hash, payload)

    def publish_cell(self, spec_hash: str, payload: Dict[str, Any], owner: str) -> bool:
        return self.global_store.cells.publish_cell(spec_hash, payload, owner)

    def success_log(self) -> List[Dict[str, Any]]:
        return self.global_store.cells.success_log()

    def sweep_stale_claims(self, ttl_s=None) -> List[str]:
        return self.global_store.cells.sweep_stale_claims(ttl_s)

    def load_cell(self, spec_hash: str) -> Dict[str, Any]:
        return self.global_store.cells.load_cell(spec_hash)

    def try_load_cell(self, spec_hash: str) -> Optional[Dict[str, Any]]:
        return self.global_store.cells.try_load_cell(spec_hash)

    def delete_cell(self, spec_hash: str) -> None:
        self.global_store.cells.delete_cell(spec_hash)

    def claim(self, spec_hash: str, owner: str, *, ttl_s=None) -> bool:
        return self.global_store.cells.claim(spec_hash, owner, ttl_s=ttl_s)

    def refresh_claim(self, spec_hash: str, owner: str) -> None:
        self.global_store.cells.refresh_claim(spec_hash, owner)

    def release_claim(self, spec_hash: str, owner: Optional[str] = None) -> None:
        self.global_store.cells.release_claim(spec_hash, owner)

    def claim_info(self, spec_hash: str) -> Optional[Dict[str, Any]]:
        return self.global_store.cells.claim_info(spec_hash)

    def release_claims_of(self, owner: str) -> List[str]:
        return self.global_store.cells.release_claims_of(owner)

    def completed(self) -> List[str]:
        """This submission's completed hashes: the manifest's cell list
        intersected with the global store (the raw global listing would
        count other campaigns' cells).  Falls back to the global listing
        before the manifest exists."""
        manifest = self.read_manifest()
        if manifest is None:
            return self.global_store.cells.completed()
        return sorted(
            c["spec_hash"]
            for c in manifest.get("cells", [])
            if self.global_store.cells.has_cell(c["spec_hash"])
        )


class GlobalStore:
    """The service's one store: shared cells + per-submission views."""

    def __init__(self, root: str = DEFAULT_SERVICE_ROOT) -> None:
        self.root = root
        self.cells = RunStore(os.path.join(root, GLOBAL_DIR))

    def view(self, submission_id: str) -> CampaignView:
        return CampaignView(self, submission_id)

    def submissions(self) -> List[str]:
        """Submission ids holding a manifest, sorted."""
        d = os.path.join(self.root, CAMPAIGN_DIR)
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return []
        return [n for n in names if os.path.isfile(os.path.join(d, n, MANIFEST))]

    def stats(self) -> Dict[str, Any]:
        return {
            "unique_cells": len(self.cells.completed()),
            "submissions": len(self.submissions()),
        }
