from .ops import polyblock_solve_fused, polyblock_solve_plain

__all__ = ["polyblock_solve_fused", "polyblock_solve_plain"]
