from .ops import polyblock_project, project_bisect
from .ref import TINY, project_ref

__all__ = ["polyblock_project", "project_bisect", "project_ref", "TINY"]
