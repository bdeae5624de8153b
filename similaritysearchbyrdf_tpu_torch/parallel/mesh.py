"""The shard mesh of the sharded engines, in one process or several.

Counterpart of `similaritysearchbyrdf_tpu/parallel/mesh.py`. A
`ForestMesh` names the shards: `shape["shard"]` is their global count (so
code that reads `mesh.shape[SHARD_AXIS]` reads what it reads on the JAX
mesh), `devices` this process's shards in global order, and a multi-process
mesh carries its process group. A device may hold more than one shard:
`make_forest_mesh(devices=["cpu"] * 8)` is the counterpart of the JAX
tests' eight virtual CPU devices, and `["cuda:0"] * 8` runs the same
8-shard programs on one card.

Global shard order is the JAX mesh's device order: process 0's shards
first, then process 1's, and so on. Every process holds the same number of
shards.

Multi-process runs: call `init_distributed` in every process with the same
`tcp://` address, then `make_forest_mesh`. The collectives (a max or a sum
of a few host numbers at fit time, k-means sums, the one all-gather of the
per-shard top-k lists) run on tensors on the first shard's device through
the group's backend: "nccl" by default for shards on CUDA, "gloo" on the
CPU. NCCL refuses two ranks on one card; ranks that share a card pass
`backend="gloo"`, whose CUDA collectives stage through the host. A backend
that cannot carry the tensors raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.families import Device

SHARD_AXIS = "shard"

# the devices `init_distributed` gave this process (None: every visible card)
_LOCAL_DEVICE_IDS: Optional[Tuple[int, ...]] = None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     backend: Optional[str] = None) -> None:
    """Join this process to a multi-process run: `torch.distributed`'s
    process group over `tcp://<coordinator_address>` (a bare `host:port`
    gets the scheme), `num_processes` ranks, this one `process_id`.
    `local_device_ids` are the CUDA cards this process's shards take
    (default: every visible card); `backend` defaults to "nccl" where CUDA
    is available, else "gloo". Nothing is detected from the environment:
    pass every argument. A second call does nothing, as in the JAX
    package."""
    global _LOCAL_DEVICE_IDS
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address, num_processes and "
                         "process_id: nothing tells a process of its cluster")
    addr = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids is not None:
        _LOCAL_DEVICE_IDS = tuple(int(i) for i in local_device_ids)
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id))


@dataclasses.dataclass(frozen=True, eq=False)
class ForestMesh:
    """A 1-D mesh of forest shards. `devices` are this process's shards in
    global order (a device may repeat), `shape["shard"]` the global shard
    count, `first_shard` the global index of `devices[0]`; `group` is the
    process group of a multi-process mesh (None in one process)."""

    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]
    process_index: int = 0
    process_count: int = 1
    first_shard: int = 0
    group: Optional[object] = None

    @property
    def n_shards(self) -> int:
        return self.shape[SHARD_AXIS]

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def comm_device(self) -> torch.device:
        """Where collectives' tensors live: the first shard's device."""
        return self.devices[0]

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` summed ("sum") or maximised ("max") over the processes, in
        place; unchanged in one process."""
        if self.process_count > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                            group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[process_count * t.shape[0], ...]: every process's `t`, in rank
        order (`t` itself in one process)."""
        if self.process_count == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.process_count)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def host_max(self, *values: float) -> Tuple[float, ...]:
        """Each value's maximum over the processes (float64)."""
        t = torch.tensor(values, dtype=torch.float64, device=self.comm_device)
        return tuple(float(v) for v in self.all_reduce(t, "max").cpu())

    def host_sum(self, value: int) -> int:
        t = torch.tensor([value], dtype=torch.int64, device=self.comm_device)
        return int(self.all_reduce(t, "sum").item())


def _visible_cards() -> Tuple[torch.device, ...]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * n to run the "
                           "shards on the CPU")
    ids = _LOCAL_DEVICE_IDS or tuple(range(torch.cuda.device_count()))
    return tuple(torch.device("cuda", i) for i in ids)


def make_forest_mesh(n_devices: Optional[int] = None,
                     devices: Optional[Sequence[Device]] = None) -> ForestMesh:
    """The 1-D shard mesh. With no `devices`, one shard on each visible card
    of this process (raising without CUDA); `n_devices` then takes the first
    n and raises past the card count, as the JAX package does. `devices`
    lists this process's shards explicitly, a device as often as it holds
    shards (`["cpu"] * 8`, `["cuda:0"] * 8`). After `init_distributed` the
    mesh spans every process's shards, process 0's first; each process must
    hold as many as the others."""
    if devices is None:
        devs = _visible_cards()
        if n_devices is not None and dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError("n_devices selects cards in one process; give a multi-process "
                             "mesh its devices instead")
        n = n_devices or len(devs)
        if n > len(devs):
            raise ValueError(f"requested {n} devices, have {len(devs)}")
        devs = devs[:n]
    else:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return ForestMesh(devices=devs, shape={SHARD_AXIS: len(devs)})
    rank, world = dist.get_rank(), dist.get_world_size()
    if devs[0].type == "cuda" and dist.get_backend() == "nccl":
        torch.cuda.set_device(devs[0])
    counts = torch.tensor([len(devs)], dtype=torch.int64, device=devs[0])
    parts = [torch.empty_like(counts) for _ in range(world)]
    dist.all_gather(parts, counts)
    per = [int(p.item()) for p in parts]
    if len(set(per)) != 1:
        raise ValueError(f"every process must hold as many shards as the others: {per}")
    return ForestMesh(devices=devs, shape={SHARD_AXIS: sum(per)}, process_index=rank,
                      process_count=world, first_shard=rank * per[0], group=None)
