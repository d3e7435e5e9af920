"""Models: the paper's CNNs via conv-as-tiled-GEMM, and the LM model zoo
(dense, MoE, SSM, hybrid and encoder-decoder families)."""

from .model_zoo import (cache_specs, decode_fn, init_model, input_specs,
                        loss_fn, model_flops, param_specs, prefill_fn)
from .params import (lm_params_from_jax, tensor_from_numpy,
                     train_state_from_jax)
from .transformer import (decode_step, init_cache, init_lm, lm_forward,
                          lm_loss, prefill, prepare_cross_cache)
from .cnn import CNNConfig, init_cnn, cnn_forward, build_simnet

__all__ = ["init_model", "loss_fn", "prefill_fn", "decode_fn", "model_flops",
           "input_specs", "cache_specs", "param_specs",
           "lm_params_from_jax", "train_state_from_jax", "tensor_from_numpy",
           "init_lm",
           "lm_forward", "lm_loss", "init_cache", "decode_step", "prefill",
           "prepare_cross_cache", "CNNConfig", "init_cnn", "cnn_forward",
           "build_simnet"]
