"""The proving mesh: shards on devices, within one process or across several.

Port of ``zkdcap_tpu/parallel/mesh.py``. A JAX ``Mesh`` names devices that
one compiled ``shard_map`` program runs on; here a :class:`Mesh` is an
ordered list of shards, each a ``torch.device``, and the sharded functions
(``parallel/sharded_msm.py``, ``parallel/sharded_ntt.py``, the prover's row
sharder) run each shard's work through :meth:`Mesh.map` and exchange blocks
through the mesh's two collectives, :meth:`Mesh.all_gather` and
:meth:`Mesh.all_to_all`. Within a process a collective is tensor copies
between the shards' devices; across processes it packs the local shards'
blocks into one tensor for one ``torch.distributed`` call, NCCL for CUDA
shards and gloo for CPU shards. No kernel reads another device's memory.

:meth:`Mesh.map` runs each shard's work, with the shards on distinct devices
in lanes, one a device, issued by one thread: a device's shards run in flat
order, and a shard's work that reads its card back (the MSM's Hillis-Steele
levels) runs as steps that end before each read, the lanes taking turns step
by step, so every card is given its work up to its next read before the
thread waits on any. The cards overlap only where a card's work outlasts the
host's issue of the other cards' (on four H100s: the 2^22 MSM, not the 2^20
MSM, the NTT or a proof); work without reads runs as the loop it replaced.
A thread a card fought for the interpreter lock at every launch (the 2^20
MSM 6x slower on four H100s than one thread). A mesh of virtual shards on
one device (``["cpu"] * 8``, ``["cuda:0"] * 4``) has one lane. The
collectives and the splits run between maps.

* :func:`proving_mesh`: one axis ``shard`` over the first n CUDA devices,
  or over an explicit device list, which may repeat a device: the
  counterpart of the JAX tests' virtual CPU devices (``["cpu"] * 8``, or
  ``["cuda:0"] * 4`` on a machine with one card).
* :func:`init_distributed`: the process group from ``ZKDCAP_COORDINATOR``,
  ``ZKDCAP_NUM_PROCESSES`` and ``ZKDCAP_PROCESS_ID``, as in the JAX package.
* :func:`multihost_mesh`: a ``(host, chip)`` mesh whose hosts are the
  group's processes; each process owns its own row of shards. Every
  process calls the same entry point with the same inputs and gets the same
  result.

A shard's flat index is row-major over ``(host, chip)``: shard c of process
r is ``r * chips + c`` (the JAX package's ``flat_axis_index``).
"""

from __future__ import annotations

import contextlib
import inspect
import math
import os
import weakref

import torch
import torch.distributed as dist

from ..device import resolve

# the process-group backend each shard device type needs
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it names now (``cuda:i``), as tensors report it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Shards (``torch.device``) of this process within a global mesh.

    ``shape`` maps axis names to sizes (``{"shard": n}`` or ``{"host": H,
    "chip": C}``); ``devices`` are this process's shards, in flat order. With
    ``group`` (a ``torch.distributed`` process group), the mesh spans the
    group's processes, each owning ``len(devices)`` consecutive shards."""

    def __init__(self, devices, shape: dict[str, int], group=None):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or next(iter(kinds)) not in _BACKENDS:
            raise ValueError(f"mesh shards must all be CUDA or all CPU devices, got {devices}")
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.processes = dist.get_world_size(group) if group is not None else 1
        if self.size != len(self.devices) * self.processes:
            raise ValueError(f"mesh {self.shape} does not hold {self.processes} process(es) "
                             f"of {len(self.devices)} shard(s)")
        if group is not None:
            backend = dist.get_backend(group)
            want = _BACKENDS[self.devices[0].type]
            if backend != want:
                raise ValueError(f"{self.devices[0].type} shards need a {want} process group, "
                                 f"got {backend}")
        self._cache: dict = {}

    @property
    def first(self) -> torch.device:
        """The device of this process's first shard: results land there."""
        return self.devices[0]

    @property
    def offset(self) -> int:
        """The flat index of this process's first shard."""
        return self.rank * len(self.devices)

    def local_shards(self) -> list[tuple[int, torch.device]]:
        """(flat index, device) of each of this process's shards."""
        return [(self.offset + i, d) for i, d in enumerate(self.devices)]

    def _lane_key(self, i: int, dev: torch.device):
        """The lane that map() issues item i (on dev) in: its device."""
        return dev

    def map(self, fn, *per_shard_args, devices=None) -> list:
        """``fn(*args)`` for each of this process's shards, with the shard's
        item of each of ``per_shard_args``; the results in flat shard order.
        ``devices``: one device of the mesh per item, where the items are
        not the shards (default: the shards' devices).

        Each device is a lane: its items run one after another in flat
        order, under ``torch.cuda.device``. An item whose ``fn`` returns a
        generator runs as steps (it yields before each host read, as
        ``msm.pippenger.msm_device_steps`` does), and the lanes take turns
        step by step: every lane issues its card's work up to its next read
        before any lane reads. An exception is raised here as it comes."""
        devs = self.devices if devices is None else [_indexed(torch.device(d)) for d in devices]
        items = list(zip(*per_shard_args)) if per_shard_args else [()] * len(devs)
        if len(items) != len(devs) or any(len(a) != len(devs) for a in per_shard_args):
            raise ValueError(f"map needs one item per device ({len(devs)})")
        lanes: dict = {}
        for i, dev in enumerate(devs):
            lanes.setdefault(self._lane_key(i, dev), []).append(i)
        out: list = [None] * len(items)

        def lane(idx):  # yields each item's device, then None before each of its steps
            for i in idx:
                yield devs[i]
                r = fn(*items[i])
                out[i] = (yield from r) if inspect.isgenerator(r) else r

        active = [[g, next(g)] for g in (lane(idx) for idx in lanes.values())]
        while active:
            for step in list(active):
                with torch.cuda.device(step[1]) if step[1].type == "cuda" \
                        else contextlib.nullcontext():
                    try:
                        step[1] = next(step[0]) or step[1]
                    except StopIteration:
                        active.remove(step)
        return out

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """This process's row blocks of x (equal, in flat shard order), each
        on its shard's device: views where the shard is x's device."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} shards")
        b = n // self.size
        return [x[g * b:(g + 1) * b].to(dev) for g, dev in self.local_shards()]

    def cached(self, owner, tag, make):
        """``make()`` once per (owner, tag) while ``owner`` lives, kept on the
        mesh: the shards' blocks of an SRS or of a proving key."""
        key = (id(owner), tag)
        hit = self._cache.get(key)
        if hit is not None and hit[0]() is owner:
            return hit[1]
        value = make()
        self._cache[key] = (weakref.ref(owner, lambda _: self._cache.pop(key, None)), value)
        return value

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}, "
                f"process {self.rank} of {self.processes})")

    def all_gather(self, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        """One tensor per local shard, all of one shape -> the blocks of
        every shard of the mesh, in flat order, on the first shard. A block
        that is already there is returned as it is: never write into one."""
        if len(blocks) != len(self.devices):
            raise ValueError(f"{len(blocks)} blocks for {len(self.devices)} local shards")
        local = [b.to(self.first) for b in blocks]
        if self.group is None:
            return local
        packed = torch.stack(local)
        out = [torch.empty_like(packed) for _ in range(self.processes)]
        dist.all_gather(out, packed, group=self.group)
        return [b for p in out for b in p.unbind(0)]

    def all_to_all(self, chunks: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
        """``chunks[s][t]``: local shard s's block for flat shard t, all of
        one shape -> ``out[t][s]``: local shard t's block from flat shard s,
        on t's device. Received blocks may alias sent ones."""
        n_local = len(self.devices)
        if len(chunks) != n_local or any(len(c) != self.size for c in chunks):
            raise ValueError(f"all_to_all needs {n_local} lists of {self.size} blocks")
        if self.group is None:
            return [[chunks[s][t].to(dev) for s in range(n_local)]
                    for t, dev in enumerate(self.devices)]
        # send[q, s, c]: local shard s's block for shard c of process q
        send = torch.stack([torch.stack([chunks[s][q * n_local + c].to(self.first)
                                         for s in range(n_local) for c in range(n_local)])
                            for q in range(self.processes)])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        recv = recv.view(self.processes, n_local, n_local, *send.shape[2:])
        # recv[p, s, c]: shard s of process p's block for local shard c
        return [[recv[p, s, c].to(dev) for p in range(self.processes) for s in range(n_local)]
                for c, dev in enumerate(self.devices)]


def _is_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a zkdcap_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")
    return mesh


def _cuda_devices(n: int | None) -> list[torch.device]:
    resolve(None)  # raises without a card: a mesh never moves to the CPU on its own
    count = torch.cuda.device_count()
    n = count if n is None else n
    if n > count:
        raise ValueError(f"need {n} CUDA devices, have {count}")
    return [torch.device("cuda", i) for i in range(n)]


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> bool:
    """Join the process group if a coordinator is configured; returns True
    when running distributed. With no coordinator this is a no-op (one
    process), so the same program serves both deployments. The backend
    follows ``device`` (default the card): NCCL for CUDA, gloo for the CPU;
    a CUDA process takes card ``process_id % device_count`` as its own."""
    coordinator_address = coordinator_address or os.environ.get("ZKDCAP_COORDINATOR")
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("ZKDCAP_NUM_PROCESSES", 1))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("ZKDCAP_PROCESS_ID", 0))
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(_BACKENDS[dev.type], init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def proving_mesh(n_devices: int | None = None, devices=None, axis: str = "shard") -> Mesh:
    """One axis over this process's shards: the first ``n_devices`` of
    ``devices`` (any torch devices, repeats allowed), or the first
    ``n_devices`` CUDA devices; raises when there are fewer."""
    if devices is None:
        devs = _cuda_devices(n_devices)
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"need {n_devices} devices, have {len(devs)}")
            devs = devs[:n_devices]
    return Mesh(devs, {axis: len(devs)})


def service_mesh(shards: int | None, device) -> Mesh | None:
    """The mesh of a prover service's ``create_proof(shards=N)``: None for N
    None or 1, N shards on the CPU for a CPU service, else N cards with the
    service's own first (its pk's device) and then the others in index
    order (raising when the machine has fewer)."""
    if shards is None or shards <= 1:
        return None
    dev = torch.device(device)
    if dev.type == "cpu":
        return proving_mesh(shards, devices=[dev] * shards)
    cards = _cuda_devices(None)
    own = _indexed(dev)
    if own not in cards:
        raise ValueError(f"no CUDA device {own}")
    if shards > len(cards):
        raise ValueError(f"need {shards} CUDA devices, have {len(cards)}")
    return proving_mesh(devices=[own] + [d for d in cards if d != own][:shards - 1])


def multihost_mesh(num_hosts: int | None = None, devices=None, host_axis: str = "host",
                   chip_axis: str = "chip") -> Mesh:
    """A ``(host, chip)`` mesh. Under ``init_distributed`` the hosts are the
    group's processes, each owning ``devices`` (default: its card) as its
    chips. In one process (no group) ``num_hosts`` carves ``devices``
    (default: every CUDA device) into host rows, as the JAX package's CPU
    simulation carves its virtual devices."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_hosts not in (None, world):
            raise ValueError(f"{num_hosts} hosts in a group of {world} processes")
        if devices is None:
            resolve(None)
            devices = [torch.device("cuda", torch.cuda.current_device())]
        devs = [torch.device(d) for d in devices]
        return Mesh(devs, {host_axis: world, chip_axis: len(devs)}, group=dist.group.WORLD)
    devs = _cuda_devices(None) if devices is None else [torch.device(d) for d in devices]
    num_hosts = num_hosts or 1
    if len(devs) % num_hosts:
        raise ValueError(f"{len(devs)} devices not divisible by {num_hosts} hosts")
    return Mesh(devs, {host_axis: num_hosts, chip_axis: len(devs) // num_hosts})


def flat_axis_index(mesh: Mesh, local: int) -> int:
    """The flat (row-major) index of this process's shard ``local``."""
    return mesh.offset + local


def axis_count(mesh: Mesh, axis) -> int:
    if isinstance(axis, str):
        return mesh.shape[axis]
    return math.prod(mesh.shape[a] for a in axis)
