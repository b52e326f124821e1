"""Multi-device runs (JAX counterpart: maua_style_tpu/parallel): the mesh,
and the spatial split of a pastiche into bands."""

from .mesh import (Mesh, Sharding, build_mesh, frame_shards, mesh_rows, pastiche_sharding_for, sharding_for,
                   window_shares)

__all__ = ["Mesh", "Sharding", "build_mesh", "frame_shards", "mesh_rows", "pastiche_sharding_for", "sharding_for",
           "window_shares"]
