"""Data parallelism of the verify plane over several devices (``mesh``)."""

from .mesh import DeviceMesh, local_devices, make_mesh, make_sharded_verifier, mesh_from_spec

__all__ = ["DeviceMesh", "local_devices", "make_mesh", "make_sharded_verifier", "mesh_from_spec"]
