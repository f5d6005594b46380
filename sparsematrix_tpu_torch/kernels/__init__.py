"""Hand-written CUDA kernels for sm_90a, each beside its plain PyTorch
version.  Importing builds nothing; a kernel is compiled at its first
launch (``_build.py``)."""
from ._build import launch_counts
from .bsr import (BSRPanels, pack_bsr_panels, spmm_bsr,
                  spmm_bsr_grouped_reference, spmm_bsr_panel_reference)
from .codebook import codebook_matmul, codebook_spmm, codebook_spmm_reference
from .spmm_blocked_ell import spmm_blocked_ell, spmm_blocked_ell_reference
from .spmm_dualgather import spmm_dualgather, spmm_dualgather_reference
from .spmm_rowlane import spmm_rowlane, spmm_rowlane_reference
from .spmv_dualgather import (DualGather, PooledDG, pack_dualgather,
                              spmv_dualgather, spmv_dualgather_reference)
from .spmv_octet import (Octet, pack_octet, spmm_octet,
                         spmm_octet_reference, spmv_octet,
                         spmv_octet_reference)
from .spmv_rowlane import (SellRowLane, pack_sell_rowlane, spmv_sell_rowlane,
                           spmv_sell_rowlane_reference)
from .spmv_sell import (SellRowPure, SellSpmv, pack_sell, pack_sell_rowpure,
                        spmv_sell, spmv_sell_reference, spmv_sell_rowpure,
                        spmv_sell_rowpure_reference)
from .stream_copy import stream_copy, stream_copy_reference
from .spmv_superblock import (SellSuperblock, pack_superblock,
                              spmv_superblock, spmv_superblock_reference)
from .trisolve_fused import (TriFusedPlan, trisolve_fused_apply,
                             trisolve_fused_apply_batched,
                             trisolve_fused_plan)
from .trisolve_waves import (TriWavesPlan, trisolve_waves_apply,
                             trisolve_waves_apply_mm, trisolve_waves_plan,
                             trisolve_waves_solve)
from .window_permute import window_permute, window_permute_reference

__all__ = [
    "launch_counts",
    "BSRPanels",
    "pack_bsr_panels",
    "spmm_bsr",
    "spmm_bsr_grouped_reference",
    "spmm_bsr_panel_reference",
    "DualGather",
    "PooledDG",
    "pack_dualgather",
    "spmv_dualgather",
    "spmv_dualgather_reference",
    "spmm_dualgather",
    "spmm_dualgather_reference",
    "Octet",
    "pack_octet",
    "spmv_octet",
    "spmv_octet_reference",
    "spmm_octet",
    "spmm_octet_reference",
    "SellSpmv",
    "pack_sell",
    "spmv_sell",
    "spmv_sell_reference",
    "SellRowPure",
    "pack_sell_rowpure",
    "spmv_sell_rowpure",
    "spmv_sell_rowpure_reference",
    "SellRowLane",
    "pack_sell_rowlane",
    "spmv_sell_rowlane",
    "spmv_sell_rowlane_reference",
    "spmm_rowlane",
    "spmm_rowlane_reference",
    "SellSuperblock",
    "pack_superblock",
    "spmv_superblock",
    "spmv_superblock_reference",
    "window_permute",
    "window_permute_reference",
    "stream_copy",
    "stream_copy_reference",
    "TriFusedPlan",
    "trisolve_fused_plan",
    "trisolve_fused_apply",
    "trisolve_fused_apply_batched",
    "TriWavesPlan",
    "trisolve_waves_plan",
    "trisolve_waves_apply",
    "trisolve_waves_apply_mm",
    "trisolve_waves_solve",
    "codebook_matmul",
    "codebook_spmm",
    "codebook_spmm_reference",
    "spmm_blocked_ell",
    "spmm_blocked_ell_reference",
]
