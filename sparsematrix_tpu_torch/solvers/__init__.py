"""Krylov solvers: CG, BiCGSTAB and block CG (``gmres``, ``lsqr`` and
``lanczos`` are not ported yet: ROADMAP.md, Queue 1 item 2)."""
from .block import BlockSolveResult, block_cg
from .krylov import SolveResult, bicgstab, cg

__all__ = ["cg", "bicgstab", "SolveResult", "block_cg", "BlockSolveResult"]
