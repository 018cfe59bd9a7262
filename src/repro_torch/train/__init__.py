"""Training step of the PyTorch port: loss, optimizers, train/eval steps."""
from .loss import chunked_softmax_xent, lm_loss
from .optimizer import (OptConfig, adafactor_init, adafactor_update,
                        adamw_init, adamw_update, opt_init, opt_state_shapes,
                        opt_update)
from .train_step import (compress_grads, global_norm, loss_and_grads,
                         make_eval_step, make_train_step)

__all__ = ["OptConfig", "adafactor_init", "adafactor_update", "adamw_init",
           "adamw_update", "chunked_softmax_xent", "compress_grads",
           "global_norm", "lm_loss", "loss_and_grads", "make_eval_step",
           "make_train_step", "opt_init", "opt_state_shapes", "opt_update"]
