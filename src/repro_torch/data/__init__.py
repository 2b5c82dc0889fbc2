"""Problem generators (counterpart of ``repro.data``): the paper's RSL
similarity pairs and the matrix-free operands.  RSL batches are a pure
function of (seed, step), so any run can regenerate any step."""
from repro_torch.data.synthetic import (RSLDataset, make_rsl_dataset,
                                        rsl_batch)

__all__ = ["RSLDataset", "make_rsl_dataset", "rsl_batch"]
