"""Mesh construction: the LM meshes and the service's device list.

The port of `repro.launch.mesh`.  Two families live here:

* **LM meshes** (`make_production_mesh`, `make_host_mesh`): the 2D / 3D
  ('pod',) 'data' x 'model' meshes that `repro_torch.parallel.sharding`'s
  rules partition over and that `models.moe.moe_ep` exchanges tokens
  over.  A `Mesh` maps axis names to sizes (`shape`, a dict in axis order,
  as a JAX mesh's), holds this process's device, and hands out the process
  group of any subset of its axes.  The single-axis groups come from
  `torch.distributed.device_mesh.init_device_mesh`; a group over several
  axes (expert parallelism over ('data', 'model'), say) is the device
  mesh's flattened group over them.  Ranks lie on the mesh in row-major
  order, as `jax.make_mesh` lays CPU devices.  A mesh of one rank with no
  initialised process group has no groups: every collective over it is the
  identity and none runs.  `AbstractMesh` carries only names and sizes,
  for the rules (the counterpart of `jax.sharding.AbstractMesh`).
* **the service's devices** (`session_devices`, `session_mesh`): each
  session's whole state lives on one card (`serve3d.placement`), so the
  service needs a list of devices, not a partitioned mesh: no tensor is
  sharded and no collective runs.

`init_distributed` joins the processes of a multi-process run (the
training CLI's ``--coordinator``): NCCL on a card, gloo on the CPU.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist


class AbstractMesh:
    """Axis names and sizes only: what the partition rules read."""

    def __init__(self, axis_sizes, axis_names):
        axis_sizes, axis_names = tuple(int(n) for n in axis_sizes), tuple(axis_names)
        if len(axis_sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes {axis_names} and sizes {axis_sizes} do not match")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """A mesh of processes, one rank a mesh position.  `device` is this
    process's device; `device_mesh` the `DeviceMesh` over the initialised
    world, or None for a one-rank mesh without a process group."""

    def __init__(self, axis_sizes, axis_names, device="cuda"):
        super().__init__(axis_sizes, axis_names)
        self.device = torch.device(device)
        self.device_mesh = None
        self._groups: dict = {}
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.size > 1 or (dist.is_initialized() and world == 1):
            if self.size != world:
                raise ValueError(f"a mesh of {self.size} ranks {self.shape} over a world of "
                                 f"{world}: launch {self.size} processes")
            from torch.distributed.device_mesh import init_device_mesh
            self.device_mesh = init_device_mesh(self.device.type, tuple(self.shape.values()),
                                                mesh_dim_names=self.axis_names)
            # every group, made now and in one order on every rank (a group is
            # made collectively)
            for k in range(2, len(self.axis_names) + 1):
                for axes in itertools.combinations(self.axis_names, k):
                    self._groups[axes] = self.device_mesh[axes]._flatten().get_group()

    def coordinate(self) -> dict:
        """This rank's index along each axis."""
        if self.device_mesh is None:
            return dict.fromkeys(self.axis_names, 0)
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def index(self, axes) -> int:
        """This rank's row-major index over `axes` (in mesh order)."""
        coord, idx = self.coordinate(), 0
        for a in self.ordered(axes):
            idx = idx * self.shape[a] + coord[a]
        return idx

    def ordered(self, axes) -> tuple:
        """`axes` as a tuple; raises unless they are mesh axes in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(set(pos)):
            raise ValueError(f"axes {axes} are not in the mesh order {self.axis_names}")
        return axes

    def group(self, axes):
        """The process group over `axes` holding this rank (None on a mesh
        without groups, or for no axes)."""
        axes = self.ordered(axes)
        if self.device_mesh is None or not axes:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]


class SessionMesh(AbstractMesh):
    """The 1D ('session',) mesh over a list of devices: bookkeeping for
    the service's placement, not a partitioning contract."""

    def __init__(self, devices):
        self.devices = list(devices)
        super().__init__((len(self.devices),), ("session",))


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device="cuda") -> None:
    """Join a run of `num_processes` processes at ``tcp://<coordinator>``
    (host:port; process 0 listens there), NCCL on a card, gloo on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", world_size=int(num_processes),
                            rank=int(process_id))


def make_host_mesh(model: int = 1, data: int = 1, device="cuda") -> Mesh:
    """A ('data', 'model') mesh over the initialised world (tests, the CLIs);
    1 x 1 when model * data exceeds it, as the reference falls back when it
    exceeds the devices."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model * data > world:
        model, data = 1, 1
    return Mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16 x 16 = 256 ranks a pod ('data', 'model'); two pods -> (2, 16, 16)
    with a leading 'pod' axis (data parallel across pods; the cross-pod hop
    is the gradient all-reduce).  Raises without a world of 256 / 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    return Mesh(shape, axes, device)


def session_devices(n: int | None = None) -> list[torch.device]:
    """The first `n` CUDA cards (all of them when n is None), the substrate
    `serve3d.placement.DevicePlacement` spreads sessions over.  Raises when
    more cards are asked for than the machine has, so a misconfigured fleet
    fails at construction, not mid-serving."""
    count = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(count)]
    if n is None:
        return devs
    n = int(n)
    if n < 1:
        raise ValueError(f"need at least one device, got n={n}")
    if n > count:
        raise ValueError(f"requested {n} devices but only {count} CUDA card(s) are "
                         "available (pass an explicit device list, e.g. "
                         "['cpu'] * n, to place sessions over slots of one device)")
    return devs[:n]


def session_mesh(n: int | None = None) -> SessionMesh:
    """1D ('session',) mesh over `session_devices(n)`."""
    return SessionMesh(session_devices(n))
