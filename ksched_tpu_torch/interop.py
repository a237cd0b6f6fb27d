"""Carrying state over from ksched_tpu, as plain numpy arrays.

The JAX package's exported problems and states are numpy arrays at its
public boundary (`DeviceGraphState.problem()`, `LayeredProblem`, a
solve's machine prices, `DeviceBulkCluster.fetch_state()`, a grouped
cluster's GroupSpec, arrival map and hybrid carry). These functions
turn such arrays into this package's objects without importing the JAX
package, so one problem or one mid-run cluster can be fed to both and
the answers compared.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .graph.device_export import FlowProblem
from .scheduler.device_bulk import DeviceClusterState, GroupSpec
from .solver.layered import LayeredProblem


def flow_problem(num_nodes: int, excess, node_type, src, dst, cap, cost,
                 flow_offset, num_arcs: int) -> FlowProblem:
    """A FlowProblem from the fields of `DeviceGraphState.problem()`
    (copies, in the dtypes this package's export uses)."""
    return FlowProblem(
        num_nodes=int(num_nodes),
        excess=np.array(excess, np.int64),  # kschedlint: host-only (host numpy)
        node_type=np.array(node_type, np.int8),
        src=np.array(src, np.int32),
        dst=np.array(dst, np.int32),
        cap=np.array(cap, np.int32),
        cost=np.array(cost, np.int32),
        flow_offset=np.array(flow_offset, np.int32),
        num_arcs=int(num_arcs),
    )


def layered_problem(supply, col_cap, cost_cm, unsched_cost: int, ec_cost: int,
                    row_unsched_cost=None) -> LayeredProblem:
    """A LayeredProblem from its fields."""
    return LayeredProblem(
        supply=np.array(supply, np.int32),
        col_cap=np.array(col_cap, np.int32),
        cost_cm=np.array(cost_cm, np.int32),
        unsched_cost=int(unsched_cost),
        ec_cost=int(ec_cost),
        row_unsched_cost=(
            None if row_unsched_cost is None
            else np.array(row_unsched_cost, np.int64)  # kschedlint: host-only (host numpy)
        ),
    )


def machine_prices(pm0, device="cpu") -> Optional[torch.Tensor]:
    """A carried machine-price vector (a solve's `pm`) as the int32
    tensor `transport_solve` takes as `pm0`; None passes through."""
    if pm0 is None:
        return None
    return torch.as_tensor(np.array(pm0, np.int32), device=device)


def device_cluster_state(np_state: dict, device="cpu") -> DeviceClusterState:
    """A DeviceClusterState on `device` from the dict of numpy arrays
    that `DeviceBulkCluster.fetch_state()` returns (either package's):
    assign it to a cluster of the same geometry's `state` to continue
    that run."""
    i32, b = np.int32, np.bool_
    dtypes = dict(live=b, cls=i32, job=i32, pu=i32, pu_running=i32,
                  machine_enabled=b, grp=i32)
    return DeviceClusterState(**{
        name: torch.as_tensor(np.array(np_state[name], dt), device=device)
        for name, dt in dtypes.items()
    })


def continue_cluster(cluster, np_state: dict, groups: Optional[dict] = None,
                     arrival=None, hybrid=None) -> None:
    """Carry a mid-run cluster into `cluster` (this package's
    DeviceBulkCluster of the same geometry): its state (fetch_state()),
    in group mode its GroupSpec fields (a dict of numpy arrays: cls, job,
    e, u [G] and pref_w [G, M], e.g. the JAX cluster's
    `groups._asdict()` fetched to numpy) and arrival map
    (map int32[G], count), and in stability-aware preemption mode its
    hybrid carry (census_ref int32[M, C], rounds since the last
    re-solve, rounds since the last global one). The next rounds then
    continue the same run."""
    dev = cluster.device
    cluster.state = device_cluster_state(np_state, dev)
    if groups is not None:
        cluster.groups = GroupSpec(**{
            name: torch.as_tensor(np.array(groups[name], np.int32), device=dev)
            for name in GroupSpec._fields
        })
        cluster._groups_cls_host = np.array(groups["cls"], np.int32)
    if arrival is not None:
        amap, count = arrival
        cluster._arrival_map = torch.as_tensor(np.array(amap, np.int32), device=dev)
        cluster._arrival_n = int(count)
    if hybrid is not None:
        census, k, kg = hybrid
        cluster._hyb_census = torch.as_tensor(np.array(census, np.int32), device=dev)
        cluster._hyb_k, cluster._hyb_kg = int(k), int(kg)


#: the array fields of a ShardedPlan (parallel/sharded_solver.py)
SHARDED_PLAN_FIELDS = (
    "s_arc", "s_sign", "s_src", "s_dst", "s_segstart", "s_isstart",
    "s_valid", "node_first", "node_last", "node_nonempty", "owned",
    "pos_fwd", "pos_bwd", "src", "dst",
)

#: the layout of a SlotPlanState in sharded mode: its ten plan tensors
#: (host_args order), the allocator state and the owner map
SHARDED_LAYOUT_FIELDS = (
    "p_arc", "p_sign", "p_src", "p_dst", "seg_start", "is_start",
    "inv_order", "node_first", "node_last", "node_nonempty",
    "region_start", "region_cap", "pos_fwd", "pos_bwd",
)


def sharded_plan(plan):
    """A parallel.sharded_solver.ShardedPlan from another package's
    ShardedPlan (or any object with its fields), as numpy copies."""
    from .parallel.sharded_solver import ShardedPlan

    return ShardedPlan(**{f: np.array(getattr(plan, f)) for f in SHARDED_PLAN_FIELDS})


def sharded_layout(plan_state) -> dict:
    """A SlotPlanState's sharded layout as a dict of numpy arrays and
    ints: the plan tensors, region table, per-slot positions, owner map,
    per-block tail frontiers and dead spans, block extent and shard
    count. Either package's SlotPlanState goes in; two layouts compare
    equal field by field."""
    out = {f: np.array(getattr(plan_state, f)) for f in SHARDED_LAYOUT_FIELDS}
    out["owner"] = np.asarray(plan_state._owner, np.int64).copy()  # kschedlint: host-only (host numpy)
    out["tail_next"] = np.asarray(plan_state._tail_next, np.int64).copy()  # kschedlint: host-only (host numpy)
    out["dead_spans"] = [[(int(s), int(c)) for s, c in spans]
                         for spans in plan_state._dead_spans]
    out["block_extent"] = int(plan_state.block_extent)
    out["entry_cap"] = int(plan_state.entry_cap)
    out["num_shards"] = int(plan_state._num_shards)
    return out
