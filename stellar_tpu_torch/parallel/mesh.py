"""Device mesh of the verify plane: batch data parallelism over cards.

A verify batch is embarrassingly parallel over its items, so the mesh has
one axis ("batch"): a chunk is cut into equal shard-major slices, one a
device, each staged into its own pinned buffer, copied straight to its
device and verified there on its own stream (``ops/ed25519.py::
BatchVerifier``).  No collective runs: each shard's verdicts come back to
one pinned host result.  The byzantine inter-validator plane stays on the
overlay's sockets; the mesh is the scale-out inside one validator.

This is the port of ``stellar_tpu/parallel/mesh.py`` (a ``jax.sharding.Mesh``
there): ``local_devices`` takes the place of ``jax.local_devices``, and the
mesh is a plain tuple of ``torch.device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from ..ops import resolve_device

AXIS = "batch"


def local_devices(kind: str = "cuda") -> list:
    """The devices this process can feed: ``cuda:0 … cuda:n-1`` (raises
    without CUDA, as ``ops.resolve_device`` does), or ``[cpu]``.  The one
    place that lists devices; tests replace it to stand in for a host with
    more cards."""
    if kind == "cuda":
        resolve_device("cuda")  # raises without CUDA
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device kind {kind!r}")


@dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh over the batch axis: shard k of a chunk runs on
    ``devices[k]``.  All devices are of one type.

    A mesh may name one device more than once (``[cuda:0] * 2``): each
    shard then still gets its own buffer and stream on that device.  That
    is a test rig, which drives every part of the sharded path but the copy
    to a second card on a host with one; it is not a deployment."""

    devices: Tuple[torch.device, ...]

    axis_names = (AXIS,)

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None, axis: str = AXIS) -> DeviceMesh:
    """1-D mesh over the given devices, by default every device
    ``local_devices()`` lists."""
    if axis != AXIS:
        raise ValueError(f"the verify plane shards one axis, {AXIS!r}; got {axis!r}")
    if devices is None:
        devices = local_devices()
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh's devices are of one type, got {devs}")
    return DeviceMesh(devs)


def mesh_from_spec(
    spec: Union[int, str, None], device="cuda", axis: str = AXIS
) -> Optional[DeviceMesh]:
    """``Config.SIG_MESH`` -> DeviceMesh or None, over the devices of
    ``device``'s type:

    - ``0`` / ``False`` / ``None``: off, the unsharded path;
    - ``"auto"``: every device; a one-device host gets None (the unsharded
      path is the one-device configuration);
    - an int ``n``: the first n devices; fewer on the host is a config
      error, not a silently narrower mesh.  ``1`` is None, as "auto" is on
      one device."""
    if not spec:
        return None
    devices = local_devices(torch.device(device).type)
    if spec == "auto":
        return make_mesh(devices, axis) if len(devices) > 1 else None
    n = int(spec)
    if n > len(devices):
        raise ValueError(
            f"SIG_MESH={n} but only {len(devices)} addressable "
            f'device(s); use SIG_MESH="auto" to take what is there'
        )
    if n == 1:
        return None
    return make_mesh(devices[:n], axis)


def make_sharded_verifier(mesh: Optional[DeviceMesh] = None, max_batch: int = 8192, **kw):
    """A BatchVerifier that shards every chunk over ``mesh`` (by default
    every local card)."""
    from ..ops.ed25519 import BatchVerifier

    if mesh is None:
        mesh = make_mesh()
    return BatchVerifier(max_batch=max_batch, mesh=mesh, **kw)
