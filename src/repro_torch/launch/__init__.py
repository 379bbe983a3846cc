"""Meshes and the multi-pod dry run (:mod:`.mesh`, :mod:`.dryrun`).
Importing the package touches no process group."""
from .mesh import (init_fake_world, make_mesh, make_mesh_for,
                   make_production_mesh, set_mesh)

__all__ = ["init_fake_world", "make_mesh", "make_mesh_for",
           "make_production_mesh", "set_mesh"]
