"""The train step (twin of ``repro.train``)."""
from .step import (chunked_ce_loss, init_dp_error_state, loss_fn,
                   make_compressed_grads, make_train_step, value_and_grad)
