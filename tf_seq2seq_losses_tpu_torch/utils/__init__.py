"""Utilities of the PyTorch port: numerics, kernel config, profiling,
debug guards and the roofline model."""

from tf_seq2seq_losses_tpu_torch.utils.config import (
    KernelConfig,
    config_override,
    get_config,
)

__all__ = ["KernelConfig", "config_override", "get_config"]
