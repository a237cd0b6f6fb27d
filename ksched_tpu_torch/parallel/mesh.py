"""The device mesh of the multi-device rung, over torch.distributed.

The JAX package runs its sharded programs under `shard_map` on a
`jax.sharding.Mesh` with one axis: each device holds its slice of the
sharded operands, replicated values are combined with `lax.psum`,
`pmax`, `pmin` and `all_gather`. The port runs the same programs as
SPMD over a torch.distributed process group: one rank per shard, every
rank runs the same host program on the same seeded state, and each
collective of the JAX program is one `dist.all_reduce` here:

- `psum`, `pmax`, `pmin`: `all_reduce` with SUM, MAX and MIN on int32
  tensors (the JAX programs are int32 throughout; int32 sums wrap on
  every backend, as `lax.psum` does);
- `all_gather`: an owner-masked SUM over a `[D, ...]` buffer in which
  each rank fills only its own row, the discipline the JAX sharded
  solve uses for its own psums. It needs nothing beyond `all_reduce`,
  which gloo implements for CUDA tensors as well as CPU ones.

`ShardMesh` takes whatever group it is given (the default group when
None) and never picks a backend: the caller initialises the group, with
a timeout, and chooses gloo or NCCL. Every collective is counted by
kind and by the call site the solver names (`counts`), so a run can
print what each superstep exchanged. A collective that fails or times
out raises `CollectiveError`, which the degradation ladder re-raises
instead of stepping down (runtime/degrade.py): a rank that stepped down
alone would leave the others waiting in their next collective.

`global_excl_prefix` is the two-level scan of the sharded transport
(`_global_excl_prefix` in the JAX package): a local exclusive cumsum
plus the totals of every lower rank.
"""

from __future__ import annotations

from collections import Counter

import torch

_I32 = torch.int32

#: the collective kinds a ShardMesh counts
KINDS = ("psum", "pmax", "pmin", "all_gather")


class CollectiveError(RuntimeError):
    """A collective of the sharded rung failed or timed out. Not
    degradable: the ranks of a group fail together or wait forever, so
    the error re-raises through the degradation ladder."""


def _dist():
    import torch.distributed as dist

    return dist


class ShardMesh:
    """One mesh axis over a torch.distributed process group.

    `size` is the group's rank count (the shard count D), `rank` this
    process's rank in it (its shard index, what `lax.axis_index` gives
    inside the JAX package's shard_map), `device` where the shard's
    tensors live. `counts[(kind, site)]` counts the collectives issued,
    `kind` one of KINDS and `site` the label the caller passed."""

    def __init__(self, group=None, device="cuda") -> None:
        from ..utils.device import resolve_device

        dist = _dist()
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "ShardMesh needs an initialised torch.distributed process "
                "group (dist.init_process_group with a timeout)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.rank < 0:
            raise ValueError("this process is not a member of the mesh's group")
        self.device = resolve_device(device)
        self.counts: Counter = Counter()

    @property
    def backend(self) -> str:
        return str(_dist().get_backend(self.group))

    # -- counting ----------------------------------------------------------

    def reset_counts(self) -> None:
        self.counts.clear()

    def totals(self) -> dict:
        """Collectives issued since the last reset, by kind."""
        out = {k: 0 for k in KINDS}
        for (kind, _site), n in self.counts.items():
            out[kind] += n
        return out

    def by_site(self) -> dict:
        """Collectives issued since the last reset, {site: {kind: n}}."""
        out: dict = {}
        for (kind, site), n in sorted(self.counts.items()):
            out.setdefault(site, {})[kind] = n
        return out

    # -- collectives -------------------------------------------------------

    def _all_reduce(self, x: torch.Tensor, op, kind: str, site: str) -> torch.Tensor:
        dist = _dist()
        if x.device != self.device:
            # the port's own tensors stray, not a solve that failed: a
            # TypeError, which the degradation ladder never absorbs
            raise TypeError(f"collective on {x.device}, mesh on {self.device}")
        shape = x.shape
        # a private contiguous copy, never the caller's tensor; 0-dim
        # payloads travel as [1]
        buf = x.reshape(-1).clone()
        self.counts[(kind, site)] += 1
        try:
            dist.all_reduce(buf, op=op, group=self.group)  # kschedlint: disable=unregistered-program -- the one collective every sharded program shares; each program is registered at its own def
        except Exception as e:  # the backend's own error types vary
            raise CollectiveError(
                f"{kind} at {site!r} failed on rank {self.rank} of "
                f"{self.size}: {e}") from e
        return buf.reshape(shape)

    def psum(self, x: torch.Tensor, site: str = "") -> torch.Tensor:
        """Sum over the ranks (int32 wraps, as lax.psum does)."""
        return self._all_reduce(x, _dist().ReduceOp.SUM, "psum", site)

    def pmax(self, x: torch.Tensor, site: str = "") -> torch.Tensor:
        return self._all_reduce(x, _dist().ReduceOp.MAX, "pmax", site)

    def pmin(self, x: torch.Tensor, site: str = "") -> torch.Tensor:
        return self._all_reduce(x, _dist().ReduceOp.MIN, "pmin", site)

    def all_gather(self, x: torch.Tensor, site: str = "") -> torch.Tensor:
        """[D, *x.shape]: every rank's x, row d from rank d. An owner-
        masked SUM: each rank writes only its own row of a zero buffer,
        so the sum holds exactly the owner's value in every row."""
        buf = torch.zeros((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        buf[self.rank] = x
        return self._all_reduce(buf, _dist().ReduceOp.SUM, "all_gather", site)

    def any(self, flag: torch.Tensor, site: str = "") -> torch.Tensor:
        """`jnp.any` over the ranks of a local bool tensor: the psum of
        its int32 count, compared with 0 (a 0-dim bool tensor)."""
        return self.psum(torch.sum(flag, dtype=_I32), site) > 0


def global_excl_prefix(mesh: ShardMesh, local_vals: torch.Tensor,
                       site: str = "") -> torch.Tensor:
    """Exclusive prefix over the global column order of values sharded
    along the last axis: the local exclusive cumsum plus the totals of
    every lower rank (one all_gather of the per-rank totals).
    local_vals: int32 [..., Mloc]."""
    local_cum = torch.cumsum(local_vals, -1, dtype=_I32)
    local_excl = local_cum - local_vals
    local_tot = local_cum[..., -1:]
    all_tot = mesh.all_gather(local_tot, site)  # [D, ..., 1]
    mask = (torch.arange(mesh.size, dtype=_I32, device=local_vals.device) < mesh.rank)
    mask = mask.reshape((mesh.size,) + (1,) * (all_tot.ndim - 1))
    offset = torch.sum(torch.where(mask, all_tot, 0), 0, dtype=_I32)
    return local_excl + offset


def init_group(backend: str, rank: int, world_size: int, init_method: str,
               timeout_s: float = 60.0, device=None):
    """`dist.init_process_group` with an explicit address and a timeout,
    so that a rank that never arrives fails the others within
    `timeout_s` instead of hanging them. For NCCL the rank's device is
    bound first (`device_id`)."""
    from datetime import timedelta

    from ..utils.device import resolve_device

    dist = _dist()
    kw = {}
    if backend == "nccl" and device is not None:
        device = resolve_device(device)
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), **kw)
