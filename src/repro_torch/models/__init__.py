"""Model zoo of the port (counterpart of ``repro.models``): layers,
attention (GQA/MLA/cross), MoE, SSD, and the per-family assembly in
``repro_torch.models.model``."""
from repro_torch.models.model import (decode_step, init_cache, init_model,
                                      loss_fn, prefill_step)

__all__ = ["decode_step", "init_cache", "init_model", "loss_fn",
           "prefill_step"]
