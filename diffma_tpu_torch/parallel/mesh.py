"""Process groups for data, tensor and sequence parallelism.

Counterpart of ``diffma_tpu/parallel/mesh.py``, and of the multi-process
start-up in ``diffma_tpu/train/train.py::_maybe_distributed``. A JAX process
holds several devices and lays them out as a ``('dp', 'tp', 'sp')`` mesh; a
PyTorch rank holds one device, so the port's mesh is a layout of ranks:
world = dp · tp · sp, ranks laid out row-major over ``(dp, tp, sp)`` as
``make_mesh`` lays out its devices. ``Mesh`` keeps one process group for each
of: the dp ranks at this rank's (tp, sp) position (the gradient average and
the loader's shard: a JAX process is the port's dp group), the tp ranks and
the sp ranks around this rank, and the tp × sp block of its dp index (the
out_proj sum of a mixer sharded over both). An axis of size 1 has no group,
and the collectives of ``parallel/collectives.py`` are then the identity, so
a world of 1 runs every path as one process does.

Parameters are replicated, as in the JAX package (its ``param_partition_spec``
is always ``P()``): ``shard_params`` broadcasts them from rank 0, and the
mixers slice what their shard needs. ``shard_batch`` takes the dp rank's
rows of a global batch; the batch is replicated over tp and sp, as JAX's
``shard_batch`` replicates it.

The launch names the backend: ``DIFFMA_DIST_BACKEND`` (``BACKEND_ENV``) is
``nccl`` or ``gloo``. By default it is ``nccl`` on the card and ``gloo`` on
the CPU. Ranks that share one card must say ``gloo``: NCCL refuses two
ranks on one device, and ``init_distributed`` raises, naming the variable,
when NCCL is asked for with fewer cards than local ranks. It never falls
back to the CPU or to another backend. Gloo runs ``all_reduce`` and
``broadcast`` on CUDA tensors by copying them to pinned host memory and
back inside its own backend; those two are the only collectives the port
calls.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["BACKEND_ENV", "Mesh", "broadcast_bytes", "init_distributed", "make_mesh",
           "shard_batch", "shard_params", "world_rank", "world_size"]

#: The environment variable that names the backend of a multi-process launch.
BACKEND_ENV = "DIFFMA_DIST_BACKEND"

Axis = Union[None, str, Tuple[str, ...]]
_AXES = ("dp", "tp", "sp")


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _rank_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", world_rank()))
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_distributed(device="cuda") -> torch.device:
    """Join the process group of a ``torch.distributed.run`` launch and
    return this rank's device.

    A launch sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
    and ``MASTER_PORT``; without it (``WORLD_SIZE`` unset or 1) nothing is
    joined and ``device`` is returned as it is. A process group that the
    caller made already is kept. On the card the rank's device is
    ``cuda:{LOCAL_RANK % device_count}``."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return _rank_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV}={backend!r}: expected nccl or gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"{BACKEND_ENV}=nccl needs CUDA devices; the device is {device}")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world > torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL needs a card per rank: {local_world} local ranks, "
                f"{torch.cuda.device_count()} cards; set {BACKEND_ENV}=gloo to share a card")
    device = _rank_device(device)
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world)
    return device


@dataclass(eq=False)
class Mesh:
    """This rank's place in a ``(dp, tp, sp)`` layout of ranks, its groups,
    and its device. ``size``, ``index`` and ``group`` take an axis name,
    a tuple of names (``("tp", "sp")``: the block of one dp index) or None
    (a group of one)."""

    dp: int
    tp: int
    sp: int
    rank: int
    device: torch.device
    groups: Dict[Tuple[str, ...], Optional[object]] = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp, "sp": self.sp}

    @property
    def coords(self) -> Dict[str, int]:
        return {"dp": self.rank // (self.tp * self.sp), "tp": (self.rank // self.sp) % self.tp,
                "sp": self.rank % self.sp}

    @staticmethod
    def _names(axis: Axis) -> Tuple[str, ...]:
        names = () if axis is None else (axis,) if isinstance(axis, str) else tuple(axis)
        if not set(names) <= set(_AXES):
            raise ValueError(f"unknown mesh axis {axis!r}; expected names from {_AXES}")
        return names

    def size(self, axis: Axis) -> int:
        n = 1
        for name in self._names(axis):
            n *= self.shape[name]
        return n

    def index(self, axis: Axis) -> int:
        """This rank's coordinate along ``axis`` (row-major over a tuple)."""
        i = 0
        for name in self._names(axis):
            i = i * self.shape[name] + self.coords[name]
        return i

    def group(self, axis: Axis):
        """The process group of the ranks that differ from this one only
        along ``axis``; None where that is this rank alone."""
        return self.groups.get(self._names(axis))

    def __deepcopy__(self, memo) -> "Mesh":
        # a handle on the process groups: a copied model (the EMA) shares it
        return self


def _groups_along(names: Sequence[str], shape: Dict[str, int]) -> Iterable[list]:
    """Every set of ranks that differ only along ``names``, in a fixed order."""
    fixed = [a for a in _AXES if a not in names]
    strides = {"dp": shape["tp"] * shape["sp"], "tp": shape["sp"], "sp": 1}

    def coords(axes):
        out = [{}]
        for a in axes:
            out = [dict(c, **{a: i}) for c in out for i in range(shape[a])]
        return out

    for base in coords(fixed):
        yield sorted(sum(strides[a] * c[a] for a in _AXES)
                     for c in (dict(base, **v) for v in coords(names)))


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, device="cuda") -> Mesh:
    """The ``(dp, tp, sp)`` mesh over the process group's ranks (``dp``
    defaults to world // (tp · sp)) on ``device`` (the card by default, as
    every entry point; ``"cpu"`` for gloo ranks on the CPU); every rank of
    the group calls it, in the same order as every other call that makes
    groups."""
    world, rank = world_size(), world_rank()
    if dp is None:
        if world % (tp * sp):
            raise ValueError(f"a parallel mesh of tp {tp} x sp {sp} needs a multiple of "
                             f"{tp * sp} ranks; the process group has {world}")
        dp = world // (tp * sp)
    if dp * tp * sp != world:
        raise ValueError(f"parallel mesh {dp}x{tp}x{sp} != {world} ranks")
    mesh = Mesh(dp, tp, sp, rank, torch.device(device))
    for names in (("dp",), ("tp",), ("sp",), ("tp", "sp")):
        if mesh.size(names) == 1:
            continue
        if names == ("tp", "sp") and 1 in (tp, sp):  # the block is the tp or the sp group
            mesh.groups[names] = mesh.groups[("sp",) if tp == 1 else ("tp",)]
            continue
        for ranks in _groups_along(names, mesh.shape):
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[names] = group
    return mesh


def _by_kind(tensors):
    kinds: Dict[tuple, list] = {}
    for t in tensors:
        kinds.setdefault((t.device, t.dtype), []).append(t)
    return kinds.values()


@torch.no_grad()
def shard_params(tensors, mesh: Mesh) -> None:
    """Replicate ``tensors`` (a module's parameters, its EMA's, an
    optimizer's state) over the mesh: rank 0's values, broadcast to every
    rank in place, one flat buffer per device and dtype."""
    if mesh.size(_AXES) == 1:
        return
    for same in _by_kind(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=0)
        torch._foreach_copy_(same, [v.view_as(t) for v, t in
                                    zip(flat.split([t.numel() for t in same]), same)])


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The dp rank's rows of a global batch (every tensor split on dim 0)."""
    d = mesh.index("dp")
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.dp:
            raise ValueError(f"{k}: {v.shape[0]} rows are not divisible by dp {mesh.dp}")
        n = v.shape[0] // mesh.dp
        out[k] = v[d * n:(d + 1) * n]
    return out


def broadcast_bytes(data: Optional[bytes], mesh: Mesh, limit: int = 4096) -> bytes:
    """Rank 0's ``data`` (no zero byte in it) on every rank; the others
    pass None."""
    if mesh.size(_AXES) == 1:
        return data
    buf = torch.zeros(limit, dtype=torch.uint8, device=mesh.device)
    if mesh.rank == 0:
        if len(data) > limit or b"\0" in data:
            raise ValueError(f"the broadcast takes up to {limit} bytes without a zero byte")
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    dist.broadcast(buf, src=0)
    return buf.cpu().numpy().tobytes().rstrip(b"\0")
