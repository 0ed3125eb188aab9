"""Process meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

The reference lays a mesh of axis names over JAX devices. Here a mesh is
laid over the ranks of a process group, one rank per device: rank ``r``
sits at the row-major coordinates of ``r`` in ``shape`` and runs on
``cuda:{r % torch.cuda.device_count()}`` (or the CPU). Nothing here
touches a device until a mesh is built, and the reference's
``make_mesh_compat`` has no counterpart: a mesh is a list of ranks.

``init_distributed`` joins this process to a group: NCCL when the device
is CUDA, gloo on the CPU. A caller may name gloo for CUDA tensors, which is
how two ranks share one card (NCCL refuses two ranks on one device, and
this module raises before it would try).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig

#: Seconds ``init_process_group`` waits for every rank, and each
#: collective for its peers, before it raises.
DEFAULT_TIMEOUT_S = 600.0

#: Backends ``init_distributed`` accepts.
BACKENDS = ("nccl", "gloo")


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``device`` as given when it names an index
    or is not CUDA, else ``cuda:{rank % torch.cuda.device_count()}``."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    cards = torch.cuda.device_count()
    if not cards:
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda", rank % cards)


def _ranks_on_this_host(num_processes: int) -> int:
    """The ranks that share this host's cards: ``LOCAL_WORLD_SIZE`` where a
    launcher sets it, else every rank (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def init_distributed(coordinator: Optional[str] = None,
                     process_id: Optional[int] = None,
                     num_processes: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a multi-process run; returns True once this process is a rank.

    ``num_processes`` unset, 0 or 1 is a no-op returning False. Otherwise
    ``coordinator`` (``host:port``, where rank 0 listens) and
    ``process_id`` are required (the reference's ``ValueError``s), and
    ``torch.distributed.init_process_group`` connects the ranks over TCP,
    waiting at most ``timeout`` seconds for them (and each collective as
    long for its peers). ``backend`` defaults to ``nccl`` when ``device``
    is CUDA (its default) and ``gloo`` on the CPU; two NCCL ranks that
    would share a card raise, naming ``--dist-backend gloo``.
    """
    if not num_processes or num_processes <= 1:
        return False
    if coordinator is None or process_id is None:
        raise ValueError(
            "multi-process launch needs --coordinator host:port and "
            "--process-id (0..num_processes-1) on every process")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} out of range for "
            f"{num_processes} processes")
    kind = torch.device(device if device is not None else "cuda").type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("the nccl backend needs CUDA devices; use "
                             "--dist-backend gloo on the CPU")
        cards = torch.cuda.device_count()
        if _ranks_on_this_host(num_processes) > cards:
            raise ValueError(
                f"{num_processes} ranks on {cards} CUDA device(s): NCCL "
                f"refuses two ranks on one device; pass --dist-backend gloo "
                f"to share a card")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", rank=process_id,
        world_size=num_processes,
        timeout=datetime.timedelta(seconds=timeout))
    return True


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A mesh of ranks: ``axis_names`` with their ``sizes`` (row-major
    over ranks ``0 .. size - 1``), this process's ``rank`` and
    ``device``, and the process ``group`` its collectives run on (None
    when this process is the whole mesh and no group exists)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        """``{axis: extent}`` in axis order, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of ranks."""
        return math.prod(self.sizes)

    @property
    def backend(self) -> Optional[str]:
        """The group's backend (None without a group)."""
        return None if self.group is None else dist.get_backend(self.group)

    def coords(self, rank: Optional[int] = None) -> dict:
        """``{axis: index}`` of ``rank`` (default: this process's)."""
        r = self.rank if rank is None else rank
        out = {}
        for ax, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            out[ax] = r % n
            r //= n
        return {ax: out[ax] for ax in self.axis_names}

    def data_slot(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """``(extent, index)`` of ``rank`` (default: this process's) over
        the client axes ``("pod", "data")``: a client's batch rows split
        into ``extent`` parts and the rank takes part ``index``; ranks
        that differ only along ``"model"`` take the same part."""
        coords, extent, index = self.coords(rank), 1, 0
        for ax, n in zip(self.axis_names, self.sizes):
            if ax in ("pod", "data"):
                extent, index = extent * n, index * n + coords[ax]
        return extent, index


def _world() -> Tuple[int, int, Optional[object]]:
    """``(size, rank, group)`` of the default group, or one process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def _mesh(shape, axes, device) -> ProcessMesh:
    size, rank, group = _world()
    n = math.prod(shape)
    if size < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, have {size}: launch "
            f"{n} processes (--num-processes)")
    if size != n:
        raise RuntimeError(
            f"mesh {tuple(shape)} covers {n} of {size} ranks: a mesh spans "
            f"every rank of the group")
    return ProcessMesh(tuple(axes), tuple(shape), rank,
                       rank_device(device if device is not None else "cuda",
                                   rank), group)


def make_host_mesh(device=None) -> ProcessMesh:
    """Every rank of the default group, as a one-axis ``("data",)`` mesh
    (one process when there is no group); ``device`` as for
    ``rank_device`` (default ``cuda``)."""
    return _mesh((_world()[0],), ("data",), device)


def mesh_config(multi_pod: bool = False) -> MeshConfig:
    """The production ``MeshConfig`` for one pod or the two-pod slice."""
    return MULTI_POD if multi_pod else SINGLE_POD


def mesh_from_config(mc: MeshConfig, device=None) -> ProcessMesh:
    """A ``MeshConfig`` laid over the ranks of the default group (raises
    unless the group has exactly ``mc.num_devices`` ranks)."""
    return _mesh(mc.shape, mc.axes, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ProcessMesh:
    """16 x 16 ranks per pod, ``("data", "model")``; two pods add a
    leading ``"pod"`` axis. Raises when the world has fewer ranks."""
    return mesh_from_config(mesh_config(multi_pod), device)
