#!/usr/bin/env python3
"""End-to-end CTC training demo: encoder -> data-parallel CTC loss -> greedy
and beam-search decoding.

    python3 tf_seq2seq_losses_tpu_torch/tools/train_ctc_asr.py [--cpu] \\
        [--steps 200] [--batch-per-device 8] [--topology classic]

The port of the JAX repo's ``examples/train_ctc_asr.py``: it trains the
flagship encoder on the same synthetic ASR task (each token has a feature
signature, plus noise) with ``make_train_step`` on a ``('data',)`` mesh over
the run's ranks (one without a launcher; under ``torchrun`` one per card),
and reports the loss and the greedy token accuracy, then the beam-4
accuracy.  It runs on the card unless ``--cpu``.  A run of 150 steps or
more must reach 90% greedy token accuracy, or it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

VOCAB, FEAT, MAX_T, MAX_L = 8, 16, 48, 6
FRAMES_PER_TOKEN = 4  # aligned with the encoder's 2x subsampling
HIDDEN, LAYERS, LEARNING_RATE = 64, 2, 3e-3
BEAM_WIDTH = 4
MIN_ACCURACY, MIN_STEPS = 0.9, 150


def synth_batch(rng, batch):
    """Synthetic utterances: each label token emits ``FRAMES_PER_TOKEN``
    frames of its signature vector plus noise; labels in [1, VOCAB) (blank
    0).  Numpy arrays, batch-major."""
    signatures = np.eye(VOCAB, FEAT) * 3.0  # token -> feature direction
    labels = rng.randint(1, VOCAB, (batch, MAX_L)).astype(np.int32)
    label_length = rng.randint(2, MAX_L + 1, (batch,)).astype(np.int32)
    feats = rng.randn(batch, MAX_T, FEAT).astype(np.float32) * 0.3
    for b in range(batch):
        t = 0
        for li in range(label_length[b]):
            feats[b, t:t + FRAMES_PER_TOKEN] += signatures[labels[b, li]]
            t += FRAMES_PER_TOKEN
    feature_length = np.minimum(label_length * FRAMES_PER_TOKEN + 4,
                                MAX_T).astype(np.int32)
    return {"features": feats, "feature_length": feature_length, "labels": labels,
            "label_length": label_length}


def token_accuracy(tokens, lengths, batch) -> float:
    """Position-wise token accuracy of decoded sequences against the labels."""
    hits = total = 0
    toks, lens = np.asarray(tokens.cpu()), np.asarray(lengths.cpu())
    for b in range(toks.shape[0]):
        n = int(batch["label_length"][b])
        pred = toks[b, :int(lens[b])].tolist()
        ref = batch["labels"][b, :n].tolist()
        hits += sum(int(p == r) for p, r in zip(pred, ref))
        total += n
    return hits / max(total, 1)


def train(steps, batch_per_device=8, topology="classic", device=None, log=print):
    """Train on the synthetic task; returns a dict with the final ``loss``,
    ``greedy_accuracy``, ``beam_accuracy`` and the trained ``model`` (this
    rank's, on ``device``; default: the CPU under gloo, else CUDA) with the
    eval batch and its ``logits``."""
    import torch

    from tf_seq2seq_losses_tpu_torch import api
    from tf_seq2seq_losses_tpu_torch.models import (
        greedy_decode_classic,
        greedy_decode_simplified,
        init_encoder,
    )
    from tf_seq2seq_losses_tpu_torch.models.encoder import subsampled_length
    from tf_seq2seq_losses_tpu_torch.parallel import global_mesh, make_train_step

    mesh = global_mesh(("data",), device=device)
    ranks = mesh.shape["data"]
    batch = batch_per_device * ranks
    log(f"ranks: {ranks} x {mesh.device.type}, global batch {batch}")
    params = init_encoder(torch.Generator().manual_seed(0), num_features=FEAT,
                          hidden=HIDDEN, vocab=VOCAB, num_layers=LAYERS,
                          device=mesh.device)
    init_state, shard, train_step = make_train_step(
        mesh, learning_rate=LEARNING_RATE, topology=topology, model_axis=None)
    state = init_state(params)
    decode = (greedy_decode_classic if topology == "classic"
              else greedy_decode_simplified)
    rng = np.random.RandomState(0)
    eval_batch = synth_batch(np.random.RandomState(999), batch)
    eval_features = torch.as_tensor(eval_batch["features"], device=mesh.device)
    eval_length = subsampled_length(
        torch.as_tensor(eval_batch["feature_length"], device=mesh.device))

    def greedy_accuracy():
        with torch.no_grad():
            logits = state.params(eval_features)
        return token_accuracy(*decode(logits, eval_length, blank_index=0), eval_batch)

    loss = None
    for step in range(1, steps + 1):
        state, loss = train_step(state, shard(synth_batch(rng, batch)))
        if step % 25 == 0 or step == 1:
            log(f"step {step:4d}  loss {float(loss):8.4f}  "
                f"greedy token acc {greedy_accuracy():5.1%}")
    accuracy = greedy_accuracy()
    with torch.no_grad():
        logits = state.params(eval_features)
        lp = torch.log_softmax(logits, dim=2)
        b_toks, b_lens, b_scores = api.ctc_beam_search_decode(
            lp, eval_length, 0, beam_width=BEAM_WIDTH, topology=topology)
    beam = token_accuracy(b_toks[:, 0], b_lens[:, 0], eval_batch)
    log(f"final greedy token accuracy: {accuracy:.1%}")
    log(f"final beam-{BEAM_WIDTH}  token accuracy: {beam:.1%} "
        f"(top-1 mean log-prob {float(b_scores[:, 0].mean()):.2f})")
    return {"loss": float(loss), "greedy_accuracy": accuracy, "beam_accuracy": beam,
            "model": state.params, "eval_batch": eval_batch, "logits": logits,
            "logit_length": eval_length}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-per-device", type=int, default=8)
    parser.add_argument("--topology", choices=["classic", "simplified"],
                        default="classic")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from tf_seq2seq_losses_tpu_torch.parallel import init_distributed

    device = torch.device("cpu" if args.cpu else "cuda")
    init_distributed(device=device)
    result = train(args.steps, args.batch_per_device, args.topology,
                   device=device if args.cpu else None)
    if args.steps >= MIN_STEPS and result["greedy_accuracy"] < MIN_ACCURACY:
        print("demo did not converge (accuracy < 90%)", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
