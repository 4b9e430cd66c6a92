"""Analytic cost priors for the H100 (``roofline``) and device meshes
(``mesh``)."""

from repro_torch.launch.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
