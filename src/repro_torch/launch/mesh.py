"""Production mesh definition (multi-pod dry-run contract): port of
``repro.launch.mesh`` over ``torch.distributed``'s ``DeviceMesh``.

A FUNCTION, not a module constant: importing this module opens no process
group and touches no device.  A ``DeviceMesh`` needs a process group of
its size first: :func:`open_fake_group` opens the fake one of 256 or 512
ranks the dry run lowers against (this process is rank 0, no collective
moves data), :func:`open_group` a real one (NCCL on the card, gloo on the
CPU).  :func:`use_mesh` binds a mesh for the model's sharding hooks
(``models.layers.constrain``), as ``jax.set_mesh`` binds the reference's.
"""
from __future__ import annotations

import contextlib
import math
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

#: the mesh bound by :func:`use_mesh` (None: off a mesh).  Process-wide,
#: not a context variable: the backward (and the remat recompute in it)
#: runs on autograd's own threads and must see the mesh the forward saw.
_BOUND = [None]

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTIPOD_SHAPE, MULTIPOD_AXES = (2, 16, 16), ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16x16 = 256 ranks per pod; (2, 16, 16) = 512 across two pods.

    ``device_type`` is ``"cuda"`` unless the caller asks for ``"cpu"``.
    The default process group must already hold that many ranks
    (:func:`open_fake_group` for the dry run)."""
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = MULTIPOD_AXES if multi_pod else POD_AXES
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with a
    ``shape`` dict, as the reference tests' fake meshes have)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def data_axes(mesh) -> tuple:
    """Axes that carry the batch dimension (pod composes with data)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def data_shards(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def model_shards(mesh) -> int:
    return axis_sizes(mesh)["model"]


def bound_mesh():
    """The mesh :func:`use_mesh` bound, or None."""
    return _BOUND[0]


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind ``mesh`` for the model's sharding hooks while the block runs;
    plain tensors met by DTensor ops count as replicated there (the
    reference's unsharded constants)."""
    saved, _BOUND[0] = _BOUND[0], mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _BOUND[0] = saved


def open_fake_group(world_size: int) -> None:
    """The default process group as a fake one of ``world_size`` ranks
    (this process is rank 0): collectives return at once and move nothing,
    so a mesh of 256 or 512 ranks lowers in one process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def open_group(rank: int = 0, world_size: int = 1, *,
               device_type: Optional[str] = None,
               init_method: Optional[str] = None) -> None:
    """A real default process group: NCCL for ``device_type="cuda"`` (the
    default; this rank's card is ``cuda:<LOCAL_RANK>``, else ``cuda:rank``),
    gloo for ``"cpu"``.  ``init_method`` defaults to a TCP store on a free
    local port (one rank) and must be given for more."""
    device_type = device_type or "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device_type='cpu' for a gloo group")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_method is needed for more than one rank")
        init_method = f"tcp://localhost:{_free_port()}"
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
