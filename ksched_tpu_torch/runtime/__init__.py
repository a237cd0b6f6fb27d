"""Runtime auxiliary subsystems: failure detection, checkpoint/resume,
round tracing, fault injection (chaos), and solver degradation.

The reference carries the *fields* for the first three (heartbeats on
ResourceStatus/TaskDescriptor, ResourceState LOST, ad hoc round timing)
but implements none of them (SURVEY §5). Here they are first-class —
and the chaos harness (chaos.py) plus the degradation ladder
(degrade.py) make the failure paths deterministic to exercise.

Port of ksched_tpu/runtime, exporting the same names.
"""

from .chaos import (
    ChaosBackendError,
    ChaosClusterAPI,
    ChaosPolicy,
    FaultInjector,
)
from .checkpoint import (
    CheckpointDamaged,
    CheckpointError,
    CheckpointMissing,
    CheckpointVersionError,
    load_bulk_checkpoint,
    load_device_checkpoint,
    load_warm_manifest,
    restore_scheduler,
    save_bulk_checkpoint,
    save_device_checkpoint,
    save_scheduler,
    save_warm_manifest,
)
from .degrade import DegradingSolver, LadderExhausted, build_degradation_ladder
from .integrity import IntegrityError, StateAuditor, WALCorrupted
from .failure import HeartbeatMonitor, RoundWatchdog
from .trace import RoundTracer

__all__ = [
    "ChaosBackendError",
    "ChaosClusterAPI",
    "ChaosPolicy",
    "CheckpointDamaged",
    "CheckpointError",
    "CheckpointMissing",
    "CheckpointVersionError",
    "DegradingSolver",
    "FaultInjector",
    "HeartbeatMonitor",
    "IntegrityError",
    "LadderExhausted",
    "RoundTracer",
    "RoundWatchdog",
    "StateAuditor",
    "WALCorrupted",
    "build_degradation_ladder",
    "load_bulk_checkpoint",
    "load_device_checkpoint",
    "load_warm_manifest",
    "restore_scheduler",
    "save_bulk_checkpoint",
    "save_device_checkpoint",
    "save_scheduler",
    "save_warm_manifest",
]
