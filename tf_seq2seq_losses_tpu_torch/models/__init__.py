"""Model layer of the port: the greedy decoders (the encoder is not ported
yet)."""

from tf_seq2seq_losses_tpu_torch.models.decoding import (
    greedy_decode_classic,
    greedy_decode_simplified,
)

__all__ = [
    "greedy_decode_classic",
    "greedy_decode_simplified",
]
