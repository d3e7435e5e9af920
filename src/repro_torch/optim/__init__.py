"""repro_torch.optim — AdamW and Adafactor for the training step, int8
gradient compression with error feedback, and the weight-only int8
param-tree quantization (:mod:`.quant`)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_lr,
                    clip_by_global_norm, global_norm)
from .adafactor import AdafactorConfig, adafactor_init, adafactor_update
from .compress import (quantize_int8, dequantize_int8, compress_tree,
                       decompress_tree, init_error_feedback)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "clip_by_global_norm", "global_norm", "AdafactorConfig",
           "adafactor_init", "adafactor_update", "quantize_int8",
           "dequantize_int8", "compress_tree", "decompress_tree",
           "init_error_feedback"]
