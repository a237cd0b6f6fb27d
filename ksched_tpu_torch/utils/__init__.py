from .backoff import ExpBackoff
from .device import resolve_device
from .ids import (
    IDGenerator,
    SlotAllocator,
    equiv_class_from_bytes,
    fnv1a_64,
    job_id_from_string,
    next_pow2,
    rand_uint64,
    resource_id_from_string,
    rng,
    seed_rng,
)
from .maps import JobMap, ResourceMap, ResourceStatus, TaskMap

__all__ = [
    "ExpBackoff",
    "IDGenerator",
    "SlotAllocator",
    "equiv_class_from_bytes",
    "fnv1a_64",
    "job_id_from_string",
    "next_pow2",
    "rand_uint64",
    "resolve_device",
    "resource_id_from_string",
    "rng",
    "seed_rng",
    "JobMap",
    "ResourceMap",
    "ResourceStatus",
    "TaskMap",
]
