"""Flagship model: a small CTC-ASR encoder in PyTorch.

Counterpart of ``tf_seq2seq_losses_tpu/models/encoder.py``: acoustic
features -> a stride-2 conv stem -> pre-norm MLP blocks -> final norm ->
vocabulary projection, the logits of ``classic_ctc_loss``.

It computes what the reference computes:

* the stem is a float32 cross-correlation of width 3 and stride 2 with
  ``"SAME"`` padding, padded explicitly (``F.conv1d`` takes no ``"same"``
  at stride 2): ``max((ceil(T/2) - 1) * 2 + 3 - T, 0)`` frames, the
  smaller half on the left;
* GELU is the tanh approximation, ``jax.nn.gelu``'s default;
* layer norm takes the population variance and eps 1e-6;
* each dense layer rounds both operands to bfloat16 and accumulates their
  products in float32 (:meth:`Encoder._product`).  A bfloat16 product is exact
  in float32 (and in TF32), so the rounded operands are multiplied in
  float32 on both devices; the casts' own backward rounds the cotangents
  to bfloat16 where the reference's transposes do.

Parameters keep the reference's names and, but for the stem, its layouts:
a dense ``w`` is ``[in, out]`` (``x @ w + b``); the stem's ``w`` is
``F.conv1d``'s ``[H, F, 3]`` (the reference's ``[3, F, H]`` permuted).
:func:`encoder_params_from_reference` and
:func:`encoder_params_to_reference` carry a parameter tree across.

On a CUDA device cuDNN computes the float32 stem with TF32 by default
(``torch.backends.cudnn.allow_tf32``), as PyTorch ships it: the logits then
differ from a CPU run of the same parameters by the stem's rounding.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6
_STEM_WIDTH = 3
_STEM_STRIDE = 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, as float32; its backward rounds the
    cotangent to bfloat16, as the transpose of the reference's cast does."""
    return x.to(torch.bfloat16).to(torch.float32)


class Dense(nn.Module):
    """The parameters of ``x @ w + b`` (:meth:`Encoder._dense`); ``w`` is
    ``[in, out]``."""

    def __init__(self, fan_in: int, fan_out: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty((fan_in, fan_out), device=device))
        self.b = nn.Parameter(torch.zeros((fan_out,), device=device))


class LayerNorm(nn.Module):
    """Layer norm over the last axis, eps 1e-6 (the reference's)."""

    def __init__(self, width: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((width,), device=device))
        self.bias = nn.Parameter(torch.zeros((width,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, LAYER_NORM_EPS)


class Stem(nn.Module):
    """Float32 conv of width 3, stride 2, ``"SAME"`` padding; ``w`` is
    ``[H, F, 3]``."""

    def __init__(self, num_features: int, hidden: int, device=None):
        super().__init__()
        self.w = nn.Parameter(
            torch.empty((hidden, num_features, _STEM_WIDTH), device=device))
        self.b = nn.Parameter(torch.zeros((hidden,), device=device))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        num_t = features.shape[1]
        out_t = -(-num_t // _STEM_STRIDE)
        total = max((out_t - 1) * _STEM_STRIDE + _STEM_WIDTH - num_t, 0)
        x = F.pad(features.transpose(1, 2), (total // 2, total - total // 2))
        return F.conv1d(x, self.w, self.b, stride=_STEM_STRIDE).transpose(1, 2)


class Block(nn.Module):
    """Pre-norm MLP block: ``x + down(gelu(up(norm(x))))``."""

    def __init__(self, hidden: int, inner: int, device=None):
        super().__init__()
        self.norm = LayerNorm(hidden, device)
        self.up = Dense(hidden, inner, device)
        self.down = Dense(inner, hidden, device)


class Encoder(nn.Module):
    """features ``[B, T, F]`` float32 -> logits ``[B, ceil(T/2), V]``.

    ``inner`` and ``head_width`` are the widths of the up projections and
    of the head that this module holds (``4 * hidden`` and ``vocab``).  A
    parallel shard (``parallel/train.py``) holds a part of each and
    overrides the hooks, identities here: ``_enter_columns`` and
    ``_shared_weight`` on the bfloat16-rounded operands of a product (so
    that a cotangent summed over ranks is summed in float32 before the
    rounding, as XLA sums partial products), ``_reduce_rows`` on a
    row-parallel product and ``_gather_vocab`` on the logits."""

    def __init__(self, num_features: int = 80, hidden: int = 512, vocab: int = 128,
                 num_layers: int = 4, device=None, inner: Optional[int] = None,
                 head_width: Optional[int] = None):
        super().__init__()
        inner = 4 * hidden if inner is None else inner
        self.stem = Stem(num_features, hidden, device)
        self.blocks = nn.ModuleList(
            Block(hidden, inner, device) for _ in range(num_layers))
        self.head = Dense(hidden, vocab if head_width is None else head_width, device)
        self.final_norm = LayerNorm(hidden, device)

    def _enter_columns(self, xq: torch.Tensor) -> torch.Tensor:
        return xq

    def _shared_weight(self, wq: torch.Tensor) -> torch.Tensor:
        return wq

    def _reduce_rows(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def _gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return logits

    def _product(self, x: torch.Tensor, layer: Dense, columns: bool) -> torch.Tensor:
        """``x @ layer.w`` with both operands rounded to bfloat16 and the
        products summed in float32 (the reference's ``_dense_bf16`` without
        its bias); ``columns``: a column-parallel product."""
        xq = _bf16(x)
        if columns:
            xq = self._enter_columns(xq)
        return xq @ self._shared_weight(_bf16(layer.w))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.stem(features), approximate="tanh")
        for block in self.blocks:
            h = self._product(block.norm(x), block.up, True) + block.up.b
            h = F.gelu(h, approximate="tanh")
            x = x + (self._reduce_rows(self._product(h, block.down, False))
                     + block.down.b)
        x = self._product(self.final_norm(x), self.head, True) + self.head.b
        return self._gather_vocab(x)


def _default_device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def init_encoder(
    generator: torch.Generator,
    num_features: int = 80,
    hidden: int = 512,
    vocab: int = 128,
    num_layers: int = 4,
    device=None,
) -> Encoder:
    """A new encoder on ``device`` (default CUDA), its weights drawn from
    ``generator``: normal with std ``sqrt(2 / fan_in)`` (the stem's fan-in
    is ``3 * num_features``), biases and norm shifts 0, norm scales 1.  The
    draws run on the generator's device, so one seed gives the same weights
    on every device."""
    device = _default_device(device)
    enc = Encoder(num_features, hidden, vocab, num_layers, device=device)

    def normal(shape, fan_in):
        draw = torch.randn(shape, generator=generator, device=generator.device)
        return (draw * np.float32(np.sqrt(2.0 / fan_in))).to(device)

    with torch.no_grad():
        enc.stem.w.copy_(normal((hidden, num_features, _STEM_WIDTH),
                                _STEM_WIDTH * num_features))
        enc.head.w.copy_(normal((hidden, vocab), hidden))
        for block in enc.blocks:
            block.up.w.copy_(normal((hidden, 4 * hidden), hidden))
            block.down.w.copy_(normal((4 * hidden, hidden), 4 * hidden))
    return enc


def apply_encoder(params: Encoder, features) -> torch.Tensor:
    """features ``[B, T, F]`` float32 -> logits ``[B, ceil(T/2), V]`` float32.
    A features array that is not a tensor goes to the encoder's device."""
    device = params.head.w.device
    return params(torch.as_tensor(features, dtype=torch.float32, device=device))


def subsampled_length(length):
    """Time length after the stride-2 ``"SAME"`` stem: ``ceil(length / 2)``."""
    return (length + 1) // 2


def encoder_params_from_reference(params: Dict[str, Any], device=None) -> Encoder:
    """The encoder of a reference parameter tree (``init_encoder`` of the
    JAX package, its leaves as numpy arrays) on ``device`` (default CUDA)."""
    stem_w = np.asarray(params["stem"]["w"])
    hidden, vocab = np.asarray(params["head"]["w"]).shape
    enc = Encoder(stem_w.shape[1], hidden, vocab, len(params["blocks"]),
                  device=_default_device(device))
    state = {"stem.w": stem_w.transpose(2, 1, 0), "stem.b": params["stem"]["b"]}
    for name in ("head", "final_norm"):
        for leaf, value in params[name].items():
            state[f"{name}.{leaf}"] = value
    for i, block in enumerate(params["blocks"]):
        for name, sub in block.items():
            for leaf, value in sub.items():
                state[f"blocks.{i}.{name}.{leaf}"] = value
    enc.load_state_dict({k: torch.as_tensor(np.array(v, np.float32))
                         for k, v in state.items()})
    return enc


def encoder_params_to_reference(enc: Encoder) -> Dict[str, Any]:
    """The inverse of :func:`encoder_params_from_reference`: the reference's
    parameter tree of ``enc``, numpy float32 leaves."""
    state = {k: v.detach().cpu().numpy() for k, v in enc.state_dict().items()}
    tree: Dict[str, Any] = {
        "stem": {"w": state["stem.w"].transpose(2, 1, 0).copy(), "b": state["stem.b"]},
        "blocks": [{} for _ in enc.blocks],
    }
    for key, value in state.items():
        parts = key.split(".")
        if parts[0] == "blocks":
            tree["blocks"][int(parts[1])].setdefault(parts[2], {})[parts[3]] = value
        elif parts[0] != "stem":
            tree.setdefault(parts[0], {})[parts[1]] = value
    return tree
