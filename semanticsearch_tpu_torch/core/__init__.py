"""core layer of semanticsearch_tpu_torch."""
from .mesh import MeshSpec, local_mesh, make_mesh

__all__ = ["MeshSpec", "make_mesh", "local_mesh"]
