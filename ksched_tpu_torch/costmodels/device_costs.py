"""Cost functions of the device-resident round.

DeviceBulkCluster's `class_cost_fn` receives the running-class census
[M, C] as an int32 tensor on the cluster's device and returns the
[C, M] int32 arc-cost matrix of the transport solve. These are the
CoCo and Whare-Map policies (costmodels/coco.py, costmodels/whare.py
`whare_cost_matrix`) in that form.

The [4, 4] x [4, M] products are integer: CUDA has no int32 matrix
product, so each is a broadcast multiply summed in int32 — a few
thousand multiply-adds per round, exact, and never routed through a
float unit. Integer `//` is floor division, as in the policies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .coco import INTERFERENCE, MAX_COST as COCO_MAX_COST
from .whare import IDLE_BONUS, MAX_COST as WHARE_MAX_COST, PSI_PRIOR

_I32 = torch.int32


def _int_product(a, census):
    """a [K, K] @ census.T [K, M], in int32."""
    return (a[:, None, :] * census[None, :, :]).sum(dim=2, dtype=_I32)


def _on_device(arrays):
    """Constants as int32 tensors, copied to a census's device once."""
    cache = {}

    def get(device):
        if device not in cache:
            cache[device] = [
                None if a is None else torch.as_tensor(
                    np.asarray(a, np.int64).astype(np.int32), device=device)  # kschedlint: host-only (host numpy)
                for a in arrays
            ]
        return cache[device]

    return get


def coco_device_cost_fn(penalties: Optional[np.ndarray] = None):
    """class_cost_fn for CoCo: census [M, 4] -> cost [4, M] int32.

    penalties: optional [M, 4] static per-machine per-incoming-class
    penalty matrix (CoCoInterferenceScores)."""
    consts = _on_device(
        [INTERFERENCE, None if penalties is None else np.asarray(penalties).T]
    )

    def fn(census):
        W, pen = consts(census.device)
        cost = _int_product(W, census.to(_I32))  # [4, M]
        if pen is not None:
            cost = cost + pen
        return torch.clamp(cost, max=COCO_MAX_COST)

    return fn


def whare_device_cost_fn(
    slots_per_machine: int,
    psi: Optional[np.ndarray] = None,
    platform_factor: Optional[np.ndarray] = None,
):
    """class_cost_fn for Whare-Map: census [M, 4] -> cost [4, M] int32.

    slots_per_machine: total slots per machine (idle(m) = slots - census
    row sum). psi: optional [4, 4] slowdown map (default: the learning
    prior). platform_factor: optional [M] percentage multiplier (100 =
    neutral) applied to the expected slowdown before the idle bonus."""
    consts = _on_device([PSI_PRIOR if psi is None else psi, platform_factor])
    slots = int(slots_per_machine)

    def fn(census):
        psi_d, plat = consts(census.device)
        c32 = census.to(_I32)
        occupied = c32.sum(dim=1, dtype=_I32)  # [M]
        tot = torch.clamp(occupied, min=1)
        expected = _int_product(psi_d, c32) // tot[None, :]  # [4, M]
        if plat is not None:
            expected = (expected * plat[None, :]) // 100
        idle = torch.clamp(slots - occupied, min=0)
        bonus = (IDLE_BONUS * idle) // slots
        cost = expected - bonus[None, :]
        return torch.clamp(cost, 0, WHARE_MAX_COST)

    return fn
