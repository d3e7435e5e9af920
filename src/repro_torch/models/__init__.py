"""Models: the paper's CNNs via conv-as-tiled-GEMM, and the LM model zoo
(dense, MoE, SSM, hybrid and encoder-decoder families)."""

from .model_zoo import (decode_fn, init_model, loss_fn, model_flops,
                        prefill_fn)
from .params import lm_params_from_jax, tensor_from_numpy
from .transformer import (decode_step, init_cache, init_lm, lm_forward,
                          lm_loss, prefill, prepare_cross_cache)
from .cnn import CNNConfig, init_cnn, cnn_forward, build_simnet

__all__ = ["init_model", "loss_fn", "prefill_fn", "decode_fn", "model_flops",
           "lm_params_from_jax", "tensor_from_numpy", "init_lm",
           "lm_forward", "lm_loss", "init_cache", "decode_step", "prefill",
           "prepare_cross_cache", "CNNConfig", "init_cnn", "cnn_forward",
           "build_simnet"]
