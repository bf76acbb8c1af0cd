"""Model layer of the port: the flagship CTC encoder and the greedy
decoders."""

from tf_seq2seq_losses_tpu_torch.models.decoding import (
    greedy_decode_classic,
    greedy_decode_simplified,
)
from tf_seq2seq_losses_tpu_torch.models.encoder import (
    apply_encoder,
    init_encoder,
    subsampled_length,
)

__all__ = [
    "apply_encoder",
    "init_encoder",
    "subsampled_length",
    "greedy_decode_classic",
    "greedy_decode_simplified",
]
