from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
