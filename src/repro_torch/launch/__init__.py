"""Device meshes (``mesh``), cell layout (``specs``), training launch
(``train``), analytic cost priors for the H100 and the dry run's roofline
(``roofline``), and the dry run over a production mesh (``dryrun``,
``op_cost``, ``profile_cell``)."""

from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh

__all__ = ["Mesh", "make_mesh", "make_production_mesh"]
