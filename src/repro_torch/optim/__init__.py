"""Optimizer substrate (port of ``repro.optim``): AdamW with a cosine
schedule and global-norm clipping, and int8 error-feedback gradient
compression over a ``torch.distributed`` group."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_lr, global_norm)
from repro_torch.optim.compression import (ef_compress_psum, int8_decode,
                                           int8_encode)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "int8_encode", "int8_decode", "ef_compress_psum"]
