"""Models of the port (RRT-MIL)."""
from .rrt import RRTMIL, build_model  # noqa: F401
