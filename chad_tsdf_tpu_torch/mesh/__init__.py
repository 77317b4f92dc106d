from .mc import TriangleMesh, marching_cubes  # noqa: F401
from .ply import read_ply, write_ply  # noqa: F401
