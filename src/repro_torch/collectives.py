"""Point-to-point exchange and reductions over one axis of a device mesh.

The one transport under the port's collectives: the sharded transform's
halo exchange (``kernels/sharded.py``) and the gradient ring of the pod
sync (``train/grad_compress.py``).  The reference writes them as
``lax.ppermute`` / ``pmax`` / ``psum`` inside ``shard_map``; here every
rank calls :class:`AxisComm` in step, and a message is a
``dist.batch_isend_irecv`` over ``mesh.get_group(axis)``.

The route follows the group's backend, never a caught error:

  * ``nccl``: CUDA tensors go to NCCL as they are.
  * ``gloo``: gloo's point-to-point moves host memory only, so a CUDA
    tensor is staged through a pinned host buffer each way
    (``gloo-pinned``); CPU tensors go directly (``gloo``).

A payload travels as the bytes of the tensor (a ``uint8`` view): NCCL has
no int16 type, and the wire carries exactly the payload, whatever its
dtype.  ``collectives.wire_bytes`` (labels ``route``, ``op``) counts the
bytes each rank sends, so a run can show what went over the wire and by
which route.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import obs

Tensor = torch.Tensor


def mesh_device(mesh) -> torch.device:
    """The device a rank's shards of ``mesh`` live on: its current card
    for a ``cuda`` mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class AxisComm:
    """This rank's view of one mesh axis: its index, the axis size, the
    process group, and the route its messages take."""

    def __init__(self, mesh, axis: str):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise KeyError(f"mesh has no axis {axis!r}; its axes are {names}")
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.size = int(mesh.size(names.index(axis)))
        self.index = int(mesh.get_local_rank(axis))
        self.backend = str(dist.get_backend(self.group))

    def route(self, device: torch.device) -> str:
        """``nccl`` | ``gloo-pinned`` | ``gloo`` for tensors on ``device``."""
        if self.backend == "nccl":
            return "nccl"
        if self.backend != "gloo":
            raise ValueError(f"no transport for backend {self.backend!r}")
        return "gloo-pinned" if device.type == "cuda" else "gloo"

    def peer(self, index: int) -> int:
        """Global rank of the axis's ``index``-th member."""
        return dist.get_global_rank(self.group, index)

    def exchange(
        self,
        sends: Sequence[Tuple[int, Tensor]],
        recvs: Sequence[Tuple[int, Tuple[int, ...], torch.dtype]],
        device: torch.device,
        op: str = "exchange",
    ) -> List[Tensor]:
        """Send each ``(peer index, tensor)`` and receive each ``(peer
        index, shape, dtype)`` in one batch; returns the received tensors
        on ``device``, in the order of ``recvs``."""
        route = self.route(device)
        staged = route == "gloo-pinned"
        ops, sent = [], 0
        for idx, t in sends:
            wire = t.contiguous().reshape(-1).view(torch.uint8)
            if staged:
                host = torch.empty(wire.numel(), dtype=torch.uint8, pin_memory=True)
                host.copy_(wire)
                wire = host
            sent += wire.numel()
            ops.append(dist.P2POp(dist.isend, wire, self.peer(idx), self.group))
        bufs = []
        for idx, shape, dtype in recvs:
            nbytes = math.prod(shape) * dtype.itemsize
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              device="cpu" if staged else device, pin_memory=staged)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, self.peer(idx), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        obs.counter("collectives.wire_bytes", route=route, op=op).inc(sent)
        out = []
        for buf, (_, shape, dtype) in zip(bufs, recvs):
            if staged:
                buf = buf.to(device, non_blocking=True)
            out.append(buf.view(dtype).reshape(shape))
        return out

    def shift(self, t: Tensor, op: str = "ring") -> Tensor:
        """One ring hop: send ``t`` to the next member, return what the
        previous one sent (``ppermute`` with ``[(i, i + 1 mod n)]``)."""
        n, i = self.size, self.index
        (got,) = self.exchange([((i + 1) % n, t)], [((i - 1) % n, tuple(t.shape), t.dtype)],
                               t.device, op=op)
        return got

    def all_reduce(self, t: Tensor, reduce_op=dist.ReduceOp.SUM, op: str = "all_reduce") -> Tensor:
        """A reduced copy of ``t`` across the axis (``t`` is not changed)."""
        route = self.route(t.device)
        buf = t.detach().to("cpu") if route == "gloo-pinned" else t.detach().clone()
        dist.all_reduce(buf, op=reduce_op, group=self.group)
        obs.counter("collectives.wire_bytes", route=route, op=op).inc(
            buf.numel() * buf.element_size())
        return buf.to(t.device) if route == "gloo-pinned" else buf

