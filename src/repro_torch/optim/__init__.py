"""AdamW with its schedule and clipping, and the compressed gradients'
error feedback (twin of ``repro.optim``)."""
from .adamw import (OptConfig, abstract_opt_state, adamw_step, global_norm,
                    init_opt_state, lr_schedule)
from .grad_compress import compress_and_reduce, init_error_state
