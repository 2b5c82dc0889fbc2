"""Sketch-resident operators: maintained count/range sketches that turn
unstructured drift into zero-iteration factorizations.  Counterpart of
``repro.sketchres``.

A :class:`~repro_torch.sketchres.state.SketchState` keeps the Tropp–Webber
sketch pair ``Y = AΩ`` / ``Z = ΨᵀA`` resident next to the operand, with
the two seeds of its hashed-sign test matrices.  Both sketches are linear
in ``A``: a COO entry stream folds in at O(nnz·ζ) through the scatter-add
kernel of ``kernels.count_sketch``, dense or factored drift by two panel
products, and :func:`~repro_torch.sketchres.state.reconstruct` re-derives
the factorization from the panels alone — ``iterations=0,
method="sketch"``.

    from repro_torch.sketchres import sketch_operand, apply_entries, reconstruct
    st = sketch_operand(A, SVDSpec(method="gnystrom", rank=20,
                                   backend="pallas"), generator=g)
    st = apply_entries(st, rows, cols, vals)
    fact = reconstruct(st, spec)
"""
from repro_torch.sketchres.state import (BUDGET, SketchState,
                                         apply_dense_delta, apply_entries,
                                         apply_lowrank_delta, is_stale,
                                         pad_entries, reconstruct,
                                         sketch_operand, staleness_ratio)

__all__ = [
    "BUDGET", "SketchState", "apply_dense_delta", "apply_entries",
    "apply_lowrank_delta", "is_stale", "pad_entries", "reconstruct",
    "sketch_operand", "staleness_ratio",
]
