"""Multi-device runs (JAX counterpart: maua_style_tpu/parallel): the mesh,
the spatial split of a pastiche into bands, and its channel split into
shares."""

from .mesh import (Mesh, Sharding, build_mesh, channel_shares, frame_shards, mesh_grid, mesh_rows,
                   pastiche_sharding_for, row_mesh, sharding_for, window_shares)

__all__ = ["Mesh", "Sharding", "build_mesh", "channel_shares", "frame_shards", "mesh_grid", "mesh_rows",
           "pastiche_sharding_for", "row_mesh", "sharding_for", "window_shares"]
