"""Problem generators (counterpart of ``repro.data``): LM token batches,
the paper's RSL similarity pairs and the matrix-free operands.  LM and
RSL batches are pure functions of (seed, step), so any run can regenerate
any step."""
from repro_torch.data.synthetic import (LMBatchSpec, RSLDataset, host_slice,
                                        lm_batch, make_rsl_dataset,
                                        rsl_batch, spec_for)

__all__ = ["LMBatchSpec", "RSLDataset", "host_slice", "lm_batch",
           "make_rsl_dataset", "rsl_batch", "spec_for"]
