"""group_table_ms: the mean milliseconds of one upkeep of the Quincy
group table inside the window (`QuincyGroupTable.evict_idle`, the pool
registered again, `sync`, `DeviceBulkCluster.set_arrival_groups`), by
the harness's host-clock span around it. None without an upkeep."""


def read(ctx):
    spans = ctx["counts"].get("group_table_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
