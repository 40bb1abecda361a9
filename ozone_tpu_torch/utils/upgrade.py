"""Layout-version / upgrade-finalization framework.

Port of `ozone_tpu/utils/upgrade.py`, the same catalog, version numbers
and `layout_version.json` schema, so either package reads a store the
other wrote. Mirror of the reference's non-rolling upgrade machinery (hadoop-hdds/common
ozone/upgrade/: LayoutFeature catalogs HDDSLayoutFeature.java:29 /
OMLayoutFeature.java, BasicUpgradeFinalizer.java:55, request gating by
layout version): each service persists a metadata layout version; new
features declare the version they need; requests/feature paths are gated
until an explicit finalize step runs the feature upgrade actions and bumps
the persisted version.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Callable, Optional

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class LayoutFeature:
    name: str
    version: int
    description: str = ""


#: Feature catalog (grows monotonically; versions never reused).
INITIAL_VERSION = 0
BUCKET_SNAPSHOTS = LayoutFeature(
    "BUCKET_SNAPSHOTS", 3,
    "bucket snapshot create/delete verbs (OMLayoutFeature analog: "
    "FILESYSTEM_SNAPSHOT)",
)
S3_CHUNKED_UPLOAD = LayoutFeature(
    "S3_CHUNKED_UPLOAD", 4,
    "aws-chunked signed streaming uploads at the S3 gateway",
)
RATIS_STREAMING_WRITE = LayoutFeature(
    "RATIS_STREAMING_WRITE", 5,
    "client-streaming block writes on the datanode "
    "(HDDSLayoutFeature analog: RATIS_DATASTREAM_PORT...)",
)
FEATURES = [
    LayoutFeature("INITIAL", 0, "base layout"),
    LayoutFeature(
        "EC_DEVICE_CODEC", 1,
        "CUDA fused encode+CRC chunk checksums on EC writes",
    ),
    LayoutFeature(
        "OM_REPLICATED_LOG", 2, "OM HA request-log replication"
    ),
    BUCKET_SNAPSHOTS,
    S3_CHUNKED_UPLOAD,
    RATIS_STREAMING_WRITE,
]
LATEST_VERSION = max(f.version for f in FEATURES)

#: OM request classes gated on a layout feature — the admission path
#: (OzoneManager.submit) refuses these before the cluster finalizes,
#: the RequestFeatureValidator mechanism
#: (request/validation/RequestFeatureValidator.java:33,84 routed by
#: RequestValidations.java:108). Keyed by request class name so the
#: request module needs no import of this one.
GATED_OM_REQUESTS = {
    "CreateSnapshot": BUCKET_SNAPSHOTS,
    "DeleteSnapshot": BUCKET_SNAPSHOTS,
    "RenameSnapshot": BUCKET_SNAPSHOTS,
}

PRE_FINALIZE_ERROR = "NOT_SUPPORTED_OPERATION_PRIOR_FINALIZATION"


class FinalizationState(Enum):
    ALREADY_FINALIZED = "ALREADY_FINALIZED"
    FINALIZATION_REQUIRED = "FINALIZATION_REQUIRED"
    FINALIZATION_DONE = "FINALIZATION_DONE"


class LayoutVersionManager:
    """Per-service persisted layout version + feature gating.

    Downgrade contract (the reference's non-rolling upgrade promise,
    BasicUpgradeFinalizer.java:55 + Nonrolling-Upgrade.md): a component
    may restart at an OLDER software version any time BEFORE the
    operator finalizes — pre-finalize, new-format features were gated,
    so the on-disk state is old-format by construction. Only a store
    whose version was reached by an explicit finalize refuses older
    software. A pre-finalize downgrade runs CLAMPED to the older
    software's version in memory; the persisted file is untouched, so
    re-upgrading restores the stored version.
    """

    def __init__(self, version_file: Path,
                 software_version: int = LATEST_VERSION):
        self.path = Path(version_file)
        self.software_version = software_version
        #: version the store actually records (>= metadata_version
        #: while running downgraded)
        self.persisted_version = software_version
        self.finalized_marker = False
        if self.path.exists():
            data = json.loads(self.path.read_text())
            self.persisted_version = data["layout_version"]
            # files from before this marker existed were written by
            # fresh installs (never explicitly finalized) -> downgradable
            self.finalized_marker = bool(data.get("finalized", False))
            self.metadata_version = self.persisted_version
        else:
            # fresh install starts at the software version (reference
            # behavior: new clusters don't need finalization)
            self.metadata_version = software_version
            self._persist()
        if self.metadata_version > software_version:
            if self.finalized_marker:
                raise RuntimeError(
                    f"metadata layout {self.metadata_version} was "
                    f"FINALIZED past software {software_version}; "
                    f"post-finalize downgrade not supported"
                )
            log.warning(
                "pre-finalize downgrade: store records layout %d, "
                "software is %d — running clamped to %d (persisted "
                "version kept for re-upgrade)",
                self.persisted_version, software_version,
                software_version)
            self.metadata_version = software_version

    def _persist(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.persisted_version = self.metadata_version
        self.path.write_text(
            json.dumps({"layout_version": self.metadata_version,
                        "finalized": self.finalized_marker})
        )

    def is_allowed(self, feature: LayoutFeature) -> bool:
        return feature.version <= self.metadata_version

    def check_allowed(self, feature: LayoutFeature) -> None:
        """Request gating (reference request/validation layer)."""
        if not self.is_allowed(feature):
            raise RuntimeError(
                f"feature {feature.name} needs layout {feature.version}, "
                f"cluster is at {self.metadata_version}; run finalize"
            )

    def needs_finalization(self) -> bool:
        return self.metadata_version < self.software_version


class UpgradeFinalizer:
    """Runs per-feature upgrade actions in version order and bumps the
    persisted version (BasicUpgradeFinalizer.java:55)."""

    def __init__(self, manager: LayoutVersionManager):
        self.manager = manager
        self._actions: dict[int, list[Callable[[], None]]] = {}

    def register_action(self, feature: LayoutFeature,
                        action: Callable[[], None]) -> None:
        self._actions.setdefault(feature.version, []).append(action)

    def finalize(self) -> FinalizationState:
        m = self.manager
        if not m.needs_finalization():
            return FinalizationState.ALREADY_FINALIZED
        # finalization is the operator's point of no return: from here
        # on, older software is refused (the downgrade window closes —
        # BasicUpgradeFinalizer contract)
        m.finalized_marker = True
        for f in sorted(FEATURES, key=lambda f: f.version):
            if m.metadata_version < f.version <= m.software_version:
                for action in self._actions.get(f.version, ()):
                    log.info("running upgrade action for %s", f.name)
                    action()
                m.metadata_version = f.version
                m._persist()
        return FinalizationState.FINALIZATION_DONE

    def status(self) -> dict:
        return {
            "metadata_version": self.manager.metadata_version,
            "software_version": self.manager.software_version,
            "needs_finalization": self.manager.needs_finalization(),
            "features": [
                {
                    "name": f.name,
                    "version": f.version,
                    "allowed": self.manager.is_allowed(f),
                }
                for f in FEATURES
            ],
        }
