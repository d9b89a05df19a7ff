from repro_torch.training.loss import IGNORE, ce_loss, chunked_ce_from_hidden
from repro_torch.training.step import make_grad_fn, make_train_step

__all__ = ["IGNORE", "ce_loss", "chunked_ce_from_hidden", "make_grad_fn",
           "make_train_step"]
