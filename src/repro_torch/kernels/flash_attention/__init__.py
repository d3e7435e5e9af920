"""flash_attention — causal or full GQA attention with an online softmax
(K4), the score engine of the LM zoo's prefill, encoder and
cross-attention."""

from .flash_attention import (HEAD_DIMS, flash_attention_library,
                              load_flash_attention)
from .ops import (FlashAttentionFunction, flash_attention,
                  flash_attention_cuda)
from .ref import attention_ref

__all__ = ["FlashAttentionFunction", "flash_attention",
           "flash_attention_cuda", "attention_ref",
           "flash_attention_library", "load_flash_attention", "HEAD_DIMS"]
