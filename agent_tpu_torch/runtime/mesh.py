"""The device mesh over the canonical ``(dp, tp, sp)`` axes — counterpart of
``agent_tpu.runtime.mesh``.

Axis vocabulary (the reference's):

- ``dp`` — data parallelism: batch rows sharded, params replicated.
- ``tp`` — tensor/model parallelism: heads and MLP hidden sharded.
- ``sp`` — sequence/context parallelism: the sequence axis of ring
  attention (:mod:`agent_tpu_torch.parallel.ring`).
- ``pp`` and ``ep`` — pipeline stages (:mod:`agent_tpu_torch.parallel.pipeline`)
  and MoE experts (:mod:`agent_tpu_torch.models.moe`); like any other name
  they are appended innermost, in the order the shape gives them.

:class:`MeshSpec` resolves a possibly partial shape over a device count
exactly as the reference does (``dp`` absorbs what the other axes leave).
:func:`build_mesh` lays a list of ``torch.device`` out on it. One process
owns the whole mesh, as one ``TpuRuntime`` does in the reference: blocks
move between its devices by ``Tensor.to`` inside that process, where the
reference's ``ppermute`` moves them inside one program.

Across processes (``runtime.distributed``) the mesh lists process 0's
devices, then process 1's, and so on, and ``owners`` says which process
holds each position; a process runs only its own positions' work
(``local_positions``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES: Tuple[str, ...] = ("dp", "tp", "sp")
# The axes some path of the port reads; TorchRuntime refuses any other.
PORTED_AXES: Tuple[str, ...] = AXES + ("pp", "ep")


def check_sizes(shape: Dict[str, int]) -> None:
    """Raise ``ValueError`` unless every axis size is a positive int."""
    for name, size in shape.items():
        if not isinstance(size, int) or size <= 0:
            raise ValueError(f"mesh axis {name!r} must be a positive int, got {size!r}")


@dataclass(frozen=True)
class MeshSpec:
    """A validated mesh shape: ordered axis name -> size, covering all devices."""

    axes: Tuple[Tuple[str, int], ...] = field(default_factory=tuple)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.sizes, dtype=np.int64))

    @staticmethod
    def resolve(n_devices: int, shape: Optional[Dict[str, int]] = None) -> "MeshSpec":
        """Fill a possibly partial shape dict into a full spec over
        ``n_devices``: absent axes are 1, except ``dp``, which absorbs every
        device the other axes leave. A shape that does not divide the device
        count is an error (the reference's rule and messages)."""
        shape = dict(shape or {})
        check_sizes(shape)
        extra = [n for n in shape if n not in AXES]
        names = AXES + tuple(extra)  # unknown axes appended innermost
        claimed = 1
        for n in names:
            if n != "dp" and n in shape:
                claimed *= shape[n]
        if n_devices % claimed:
            raise ValueError(
                f"mesh shape {shape} claims {claimed} devices per dp-slice but "
                f"{n_devices} devices are available (not divisible)"
            )
        dp = shape.get("dp", n_devices // claimed)
        sizes = {**{n: 1 for n in names}, **shape, "dp": dp}
        total = 1
        for n in names:
            total *= sizes[n]
        if total != n_devices:
            raise ValueError(f"mesh shape {shape} covers {total} devices, have {n_devices}")
        return MeshSpec(axes=tuple((n, sizes[n]) for n in names))


@dataclass(frozen=True)
class Mesh:
    """Devices laid out on named axes: ``devices`` is an object ndarray of
    ``torch.device`` of shape ``spec.sizes``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    # The process that holds each position (an int ndarray of the devices'
    # shape), None when this process holds them all; and this process's
    # index.
    owners: Optional[np.ndarray] = None
    process_index: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        """Whether another process holds some position of this mesh."""
        return self.owners is not None and bool((self.owners != self.process_index).any())

    def owner_at(self, **coords: int) -> int:
        """The process holding the position at ``coords`` (absent axes 0)."""
        if self.owners is None:
            return self.process_index
        return int(self.owners[tuple(coords.get(n, 0) for n in self.axis_names)])

    def is_local(self, **coords: int) -> bool:
        return self.owner_at(**coords) == self.process_index

    def local_positions(self) -> List[Dict[str, int]]:
        """The positions this process holds, as axis -> coordinate, in the
        mesh's (C) order."""
        grid = np.indices(self.devices.shape).reshape(len(self.axis_names), -1).T
        out = [dict(zip(self.axis_names, map(int, row))) for row in grid]
        return [c for c in out if self.is_local(**c)]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (an absent axis is 0)."""
        return self.devices[tuple(coords.get(n, 0) for n in self.axis_names)]


def axis_groups(mesh: Mesh, axis: str) -> List[List[torch.device]]:
    """The devices along ``axis``, one list per coordinate of the other axes
    (in the mesh's order): the groups a collective over ``axis`` joins. A
    mesh without the axis gives one-device groups."""
    if axis not in mesh.axis_names:
        return [[d] for d in mesh.devices.reshape(-1)]
    k = mesh.axis_names.index(axis)
    grid = np.moveaxis(mesh.devices, k, -1)
    return [list(row) for row in grid.reshape(-1, grid.shape[-1])]


@functools.lru_cache(maxsize=None)
def one_device_mesh(device: torch.device) -> "Mesh":
    """The mesh of one shard on ``device``, built once per device: the mesh
    a one-device model runs its sharded forward on."""
    return build_mesh([device])


def build_mesh(devices: Sequence, shape: Optional[Dict[str, int]] = None,
               owners: Optional[Sequence[int]] = None, process_index: int = 0) -> Mesh:
    """A :class:`Mesh` over ``devices`` (kept in the order given) with spec
    ``shape``; ``owners``, one process index a device, when the devices
    are several processes'.

    A device may appear more than once, when the caller lists it so: then
    several shards of the mesh live on one card (or on the CPU), the
    counterpart of the reference's virtual host devices
    (``--xla_force_host_platform_device_count``). That is how one card runs
    an ``sp`` ring, and how the tests run one on the CPU."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("build_mesh: no devices")
    spec = MeshSpec.resolve(len(devs), shape)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    held = None
    if owners is not None:
        if len(owners) != len(devs):
            raise ValueError(f"build_mesh: {len(owners)} owners for {len(devs)} devices")
        held = np.asarray(owners, dtype=np.int64).reshape(spec.sizes)
    return Mesh(grid.reshape(spec.sizes), spec.names, held, process_index)
