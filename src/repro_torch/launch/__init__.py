"""Launchers of the port: serving, training and the multi-pod dry run
(``python -m repro_torch.launch.{serve,train,dryrun}``), and the meshes."""
from .mesh import HW, AbstractMesh, fake_process_group, make_mesh, make_production_mesh

__all__ = ["HW", "AbstractMesh", "fake_process_group", "make_mesh", "make_production_mesh"]
