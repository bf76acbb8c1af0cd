"""CTC decoding: best-path (greedy) and prefix beam search, in PyTorch.

Counterpart of ``tf_seq2seq_losses_tpu/ops/decode.py``.  The JAX package
vmaps a one-sample beam search over the batch; here every step is batched
over ``B`` directly.  The beam state is fixed-shape: ``tokens [B, K,
Lcap]``, ``length/last [B, K]``, per-prefix probability components ``(pb,
pnb)`` (paths ending in blank / non-blank), and a pair of independent
rolling 32-bit prefix hashes.  Each frame pools the ``K`` "stay"
candidates with the ``K x V`` single-token extensions, merges duplicate
prefixes exactly by sorting the pool on the hash pair, combining runs of
equal hashes and keeping one representative per run, then prunes to the
top ``K`` by total probability.

The merges and their order of ties are the JAX package's:

* the hashes are uint32 there; here int64 holding 32 bits, updated by
  :func:`hash_step` without overflow (16-bit halves);
* ``jnp.lexsort((h2, h1))`` is a stable sort by ``h1`` then ``h2``: two
  stable sorts here, by ``h2`` then by ``h1`` (a single ``(h1 << 32) | h2``
  int64 key would order the sentinels with bit 31 set as negative);
* ``jax.lax.top_k`` puts the lower index first on ties, and the pool is
  full of ``-inf`` ties: a stable descending sort here, not ``torch.topk``;
* the final ``jnp.argsort(-score)`` is a stable argsort.

The pool's tokens are not materialised: each selected candidate's tokens
are its parent beam's with at most one position written, the write the
JAX package makes in the pool.

That loop, :func:`beam_search_plain`, is the CPU implementation of the op
``ctc_port::beam_search``; on CUDA tensors the op launches
csrc/beam_search.cu once a call, which writes the loop's bits by another
route (one CTA a row over all T frames: the pool sorted by ``(h1, h2,
pool index)``, each run merged at its head, the top K by a composite key,
back-pointers in place of token copies, a backtrack at the end).
:func:`beam_search_schedule` models those steps in plain PyTorch for the
tests.

The scores are differentiable in the log-probabilities.  Their backward is
the op ``ctc_port::beam_search_grad`` (``cuda_lattice.op_with_grad``): on
CUDA tensors csrc/beam_search.cu's backward kernel, once a call (the
frames again, keeping a record of each, then the reverse chain); on CPU
tensors :func:`beam_search_grad_plain`, the loop's frames again and then
autograd's reverse chain through them written out, bit for bit autograd
through :func:`beam_search_plain`, its sums in the orders of torch's CPU
sum kernel (:func:`cascade_sum`, :func:`ilp_sum`, :func:`lane_sum`,
:func:`beam_sum`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tf_seq2seq_losses_tpu_torch.ops import _build
from tf_seq2seq_losses_tpu_torch.ops.cuda_lattice import (
    check_tensor,
    kernel_op,
    op_with_grad,
    plain_grad,
    register_fold,
)
from tf_seq2seq_losses_tpu_torch.utils.numerics import (
    logsumexp as _lse,
    unsorted_segment_logsumexp,
)

NEG_INF = float("-inf")
# independent multiplicative rolling-hash constants (odd, so invertible
# mod 2^32: single-token extensions never collide trivially)
H1_MULT = 0x85EBCA6B
H2_MULT = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF
_BIT31 = 1 << 31


def hash_step(h: torch.Tensor, mult: int, token: torch.Tensor) -> torch.Tensor:
    """``(h * mult + token + 1) mod 2^32`` on int64 tensors holding uint32
    values, as the JAX package's uint32 arithmetic wraps.  ``h * mult``
    needs 64 bits and would overflow int64, so ``h`` is split into 16-bit
    halves: ``lo * mult < 2^48`` and only the low 16 bits of ``hi * mult``
    reach the result."""
    lo = h & 0xFFFF
    hi = h >> 16
    prod = lo * mult + (((hi * mult) & 0xFFFF) << 16)
    return (prod + token + 1) & _MASK32


def greedy_decode(
    logprobas: torch.Tensor,  # [B, T, V]
    logit_length: torch.Tensor,  # [B]
    blank_index: torch.Tensor,  # [] int
    max_length: int,
    merge_repeats: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best-path (greedy) decoding, the ``tf.nn.ctc_greedy_decoder``
    analogue: the arg-max token of every frame ``t < logit_length``
    (the first maximum on ties, as ``jnp.argmax``), consecutive repeats
    collapsed when ``merge_repeats`` (classic topology), blanks dropped,
    survivors left-compacted.

    Returns ``(tokens [B, max_length] int32, lengths [B] int32, scores [B])``
    where ``scores`` is the log-probability of the greedy frame path and
    token slots at and after ``lengths`` are zero.  Decodes longer than
    ``max_length`` are truncated (the length reports the clipped value).
    """
    num_b, num_t, _ = logprobas.shape
    device = logprobas.device
    lp = logprobas.to(torch.float32)
    best_lp = torch.amax(lp, dim=2)  # [B, T]
    am = torch.argmax(lp, dim=2)  # [B, T], first maximum

    t_ids = torch.arange(num_t, device=device)[None, :]
    valid = t_ids < logit_length.to(device)[:, None]
    scores = torch.sum(torch.where(valid, best_lp, torch.zeros_like(best_lp)), dim=1)

    keep = valid & (am != blank_index)
    if merge_repeats:
        prev = torch.cat(
            [torch.full((num_b, 1), -1, dtype=am.dtype, device=device), am[:, :-1]],
            dim=1,
        )
        # frame 0 always starts a run; lengths mask a contiguous prefix, so
        # for t >= 1 the previous frame is valid whenever frame t is
        keep &= am != prev

    pos = _positions_op(keep)  # [B, T]
    lengths = torch.clamp(pos[:, -1] + 1, max=max_length)
    # kept tokens go to their compacted slot; dropped and overflowing frames
    # all land in a sacrificial slot `max_length` that is sliced off (kept
    # in-range slots are written at most once, so order is irrelevant)
    idx = torch.where(keep & (pos < max_length), pos, torch.full_like(pos, max_length))
    tokens = torch.zeros((num_b, max_length + 1), dtype=torch.int64, device=device)
    tokens = tokens.scatter(1, idx, am)[:, :max_length]
    return tokens.to(torch.int32), lengths.to(torch.int32), scores


def _positions(keep: torch.Tensor) -> torch.Tensor:
    """The compacted slot of each frame of ``keep`` [B, T] bool: the kept
    frames before it and itself, less one."""
    return torch.cumsum(keep.to(torch.int64), dim=1) - 1


# an op, so that torch.compile calls PyTorch's cumsum here: inductor's own
# code for this scan (a Triton split scan) failed to generate (PyTorch 2.11,
# H100)
_positions_op = torch.library.custom_op("ctc_port::greedy_positions", _positions,
                                        mutates_args=())
_positions_op.register_fake(lambda keep: keep.new_empty(keep.shape, dtype=torch.int64))
register_fold(_positions_op, (0,), (0,))


def _initial_beams(num_b: int, k: int, l_cap: int, device):
    """Beam 0 is the empty prefix with probability 1; the rest are dead
    slots with distinct sentinel hashes (bit 31 set, the two derived from
    different constants so the pair stays independent), which can never
    merge with a live prefix."""
    tokens = torch.zeros((num_b, k, l_cap), dtype=torch.int32, device=device)
    length = torch.zeros((num_b, k), dtype=torch.int64, device=device)
    last = torch.full((num_b, k), -1, dtype=torch.int64, device=device)
    iota = torch.arange(k, dtype=torch.int64, device=device)
    # beam 0 by torch.where, not by writing Python numbers into device
    # tensors (a host-to-device copy, which a CUDA graph cannot capture)
    first = iota == 0
    h1 = torch.where(first, 0, iota | _BIT31)
    h2 = torch.where(first, 0, ((iota * H2_MULT) & _MASK32) | _BIT31)
    pb = torch.where(first, 0.0, NEG_INF).expand(num_b, k).clone()
    pnb = torch.full((num_b, k), NEG_INF, device=device)
    return (tokens, length, last, h1.expand(num_b, k).clone(),
            h2.expand(num_b, k).clone(), pb, pnb)


def _lexsort(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((h2, h1))`` along dim 1: a stable sort by ``h1``, ties
    by ``h2``, as two stable sorts (the minor key first)."""
    by_h2 = torch.sort(h2, dim=1, stable=True).indices
    by_h1 = torch.sort(torch.gather(h1, 1, by_h2), dim=1, stable=True).indices
    return torch.gather(by_h2, 1, by_h1)


def _pool(state, lp_t, live, blank, l_cap: int, merge_repeats: bool):
    """A frame's pool of ``n = K (1 + V)`` candidates, in pool order:
    candidate ``k (1 + V)`` is beam k's stay, ``k (1 + V) + 1 + v`` its
    extension by token v.  Returns ``(length, last, h1, h2)`` [B, n] and
    their ``(pb, pnb)`` [B, n, 2], before the merge."""
    _, length, last, h1, h2, pb, pnb = state
    num_b, k = pb.shape
    vocab = lp_t.shape[1]
    n_cand = k * (1 + vocab)
    device = lp_t.device
    tok_ids = torch.arange(vocab, dtype=torch.int64, device=device)
    neg_inf = torch.full((), NEG_INF, device=device)

    # frames past logit_length behave as forced blank: stay with +0
    blank_lp = torch.where(live, lp_t.index_select(1, blank.reshape(1))[:, 0],
                           torch.zeros((), device=device))  # [B]
    tok_lp = torch.where(live[:, None], lp_t, neg_inf)  # [B, V]
    tot = _lse(pb, pnb)  # [B, K]

    # stay candidates (prefix unchanged)
    stay_pb = tot + blank_lp[:, None]
    if merge_repeats:
        # classic: a repeated last token continues the same prefix
        last_lp = torch.where(last >= 0,
                              torch.gather(tok_lp, 1, torch.clamp(last, min=0)),
                              neg_inf)
        stay_pnb = pnb + last_lp
        # extending with the last token requires paths ending in blank
        base = torch.where(tok_ids == last[..., None], pb[..., None], tot[..., None])
    else:
        stay_pnb = torch.full_like(pb, NEG_INF)
        base = tot[..., None]
    ext_pnb = base + tok_lp[:, None, :]  # [B, K, V]
    dead = ((tok_ids == blank)[None, None, :] | (length >= l_cap)[..., None]
            | ~live[:, None, None])
    ext_pnb = torch.where(dead, neg_inf, ext_pnb)

    ext_length = torch.clamp(length + 1, max=l_cap)[..., None].expand(-1, -1, vocab)
    ext_last = tok_ids.expand(num_b, k, vocab)
    ext_h1 = hash_step(h1[..., None], H1_MULT, tok_ids)
    ext_h2 = hash_step(h2[..., None], H2_MULT, tok_ids)

    def pool(stay, ext):  # [B, K], [B, K, V] -> [B, K * (1 + V)]
        return torch.cat([stay[..., None], ext], dim=2).reshape(num_b, n_cand)

    # (pb, pnb) of each candidate, merged together after
    c_p = torch.stack([pool(stay_pb, torch.full_like(ext_pnb, NEG_INF)),
                       pool(stay_pnb, ext_pnb)], dim=2)  # [B, n_cand, 2]
    return (pool(length, ext_length), pool(last, ext_last), pool(h1, ext_h1),
            pool(h2, ext_h2), c_p)


class _Merge(NamedTuple):
    """A frame's merge and top K: the pool's sorted order [B, n], the runs'
    heads [B, n], each sorted position's run in one segment space for the
    batch [B * n], the pool's (pb, pnb) in sorted order [B * n, 2], the
    selected sorted positions [B, K] and their merged (pb, pnb) [B, K]."""
    order: torch.Tensor
    new_run: torch.Tensor
    flat_seg: torch.Tensor
    sorted_p: torch.Tensor
    top: torch.Tensor
    pb: torch.Tensor
    pnb: torch.Tensor


def _merge(c_h1, c_h2, c_p, k: int) -> _Merge:
    """The exact merge of a frame's pool (:func:`_pool`) and its top ``k``."""
    num_b, n_cand = c_h1.shape
    device = c_h1.device
    neg_inf = torch.full((), NEG_INF, device=device)
    # exact merge of duplicate prefixes: sort on the hash pair, combine
    # runs, keep one representative per run
    order = _lexsort(c_h1, c_h2)
    s_h1, s_h2 = torch.gather(c_h1, 1, order), torch.gather(c_h2, 1, order)
    new_run = torch.ones_like(order, dtype=torch.bool)
    new_run[:, 1:] = (s_h1[:, 1:] != s_h1[:, :-1]) | (s_h2[:, 1:] != s_h2[:, :-1])
    seg = torch.cumsum(new_run.to(torch.int64), dim=1) - 1
    # one segment space for the whole batch: row b's runs at b * n_cand + seg
    flat_seg = (seg + n_cand * torch.arange(num_b, device=device)[:, None]).reshape(-1)

    sorted_p = torch.gather(c_p, 1, order[..., None].expand(-1, -1, 2)).reshape(-1, 2)
    merged = unsorted_segment_logsumexp(sorted_p, flat_seg, num_b * n_cand)
    rep = merged.index_select(0, flat_seg).reshape(num_b, n_cand, 2)
    rep = torch.where(new_run[..., None], rep, neg_inf)
    rep_pb, rep_pnb = rep[..., 0], rep[..., 1]

    # prune to the top K by total probability, lower position first on ties
    score = _lse(rep_pb, rep_pnb)
    top = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    return _Merge(order, new_run, flat_seg, sorted_p, top, torch.gather(rep_pb, 1, top),
                  torch.gather(rep_pnb, 1, top))


def _frame(state, lp_t, live, blank, l_cap: int, merge_repeats: bool):
    """One frame of the batched prefix beam search."""
    tokens, length = state[0], state[1]
    k = length.shape[1]
    vocab = lp_t.shape[1]
    device = lp_t.device
    c_length, c_last, c_h1, c_h2, c_p = _pool(state, lp_t, live, blank, l_cap,
                                              merge_repeats)
    m = _merge(c_h1, c_h2, c_p, k)
    sel = torch.gather(m.order, 1, m.top)

    # the selected candidates' tokens: the parent beam's, and for an
    # extension its token written at min(length, Lcap - 1)
    parent = sel // (1 + vocab)
    ext_token = sel % (1 + vocab) - 1  # -1 for a stay candidate
    new_tokens = torch.gather(tokens, 1, parent[..., None].expand(-1, -1, l_cap))
    if l_cap > 0:
        slot = torch.clamp(torch.gather(length, 1, parent), max=l_cap - 1)
        write = (torch.arange(l_cap, device=device) == slot[..., None]) \
            & (ext_token >= 0)[..., None]
        new_tokens = torch.where(write, ext_token.to(torch.int32)[..., None], new_tokens)
    return (
        new_tokens,
        torch.gather(c_length, 1, sel),
        torch.gather(c_last, 1, sel),
        torch.gather(c_h1, 1, sel),
        torch.gather(c_h2, 1, sel),
        m.pb,
        m.pnb,
    )


def beam_search(
    logprobas: torch.Tensor,  # [B, T, V]
    logit_length: torch.Tensor,  # [B]
    blank_index: torch.Tensor,  # [] int
    beam_width: int,
    max_length: int,
    merge_repeats: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prefix beam search (see the module docstring).

    Returns ``(tokens [B, K, max_length] int32, lengths [B, K] int32,
    scores [B, K])``, beams sorted by descending total log-probability.
    With ``beam_width`` at least the number of reachable prefixes nothing
    is pruned and every score is the sequence's exact total CTC
    probability.

    The op ``ctc_port::beam_search`` over the canonical inputs: CUDA
    tensors launch csrc/beam_search.cu once (the kernels
    ``classic_beam_search`` and ``simplified_beam_search`` by
    ``merge_repeats``), which writes :func:`beam_search_plain`'s bits; CPU
    tensors run that loop over T.  Neither reads anything back to the host
    (a CUDA graph captures the launch).  A blank outside ``[0, V)`` raises
    in the loop, and gives NaN scores from the kernel.  The op keeps the search out of
    ``torch.compile``'s trace and folds ``vmap``'s groups into the batch:
    rows are independent.  The scores are differentiable: where a gradient
    is asked, the op's backward is :func:`beam_search_grad` (the kernels
    ``classic_beam_search_grad`` and ``simplified_beam_search_grad`` on
    CUDA tensors, :func:`beam_search_grad_plain` on CPU tensors); else the
    op runs alone."""
    device = logprobas.device
    return _beam_search(
        logprobas.to(torch.float32).contiguous(),
        logit_length.to(device=device, dtype=torch.int64).contiguous(),
        blank_index.to(device=device, dtype=torch.int64).reshape(()),
        beam_width, max_length, merge_repeats)


def classic_beam_search(logprobas: torch.Tensor, logit_length: torch.Tensor,
                        blank: torch.Tensor, beam_width: int, max_length: int):
    """The kernel ``classic_beam_search``: the op with ``merge_repeats``, over
    float32 ``logprobas`` [B, T, V], int64 ``logit_length`` [B] and
    ``blank`` [].  ``.launches`` counts its launches."""
    return _beam_search(logprobas, logit_length, blank, beam_width, max_length, True)


def simplified_beam_search(logprobas: torch.Tensor, logit_length: torch.Tensor,
                           blank: torch.Tensor, beam_width: int, max_length: int):
    """The kernel ``simplified_beam_search``: the op without ``merge_repeats``."""
    return _beam_search(logprobas, logit_length, blank, beam_width, max_length, False)


classic_beam_search.launches = 0
simplified_beam_search.launches = 0


def beam_search_plain(logprobas: torch.Tensor, logit_length: torch.Tensor,
                      blank: torch.Tensor, beam_width: int, max_length: int,
                      merge_repeats: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                                    torch.Tensor]:
    """The batched loop over T of :func:`beam_search` (float32 ``logprobas``
    [B, T, V], int64 ``logit_length`` [B] and ``blank`` []), the plain
    version of csrc/beam_search.cu."""
    num_b, num_t, _ = logprobas.shape
    device = logprobas.device
    state = _initial_beams(num_b, beam_width, max_length, device)
    for t in range(num_t):
        state = _frame(state, logprobas[:, t], t < logit_length, blank, max_length,
                       merge_repeats)
    tokens, length, _, _, _, pb, pnb = state
    score = _lse(pb, pnb)
    # the last frame's beams are in top-K order already; re-sort as the
    # JAX package does, stably
    order = torch.argsort(-score, dim=1, stable=True)
    tokens = torch.gather(tokens, 1, order[..., None].expand_as(tokens))
    return (tokens, torch.gather(length, 1, order).to(torch.int32),
            torch.gather(score, 1, order))


_beam_search_op = kernel_op("beam_search", beam_search_plain)
register_fold(_beam_search_op, (0, 0, None, None, None, None), (0, 0, 0))


@_beam_search_op.register_fake
def _beam_search_fake(logprobas, logit_length, blank, beam_width, max_length,
                      merge_repeats):
    num_b = logprobas.shape[0]
    return (logprobas.new_empty((num_b, beam_width, max_length), dtype=torch.int32),
            logprobas.new_empty((num_b, beam_width), dtype=torch.int32),
            logprobas.new_empty((num_b, beam_width)))


@_beam_search_op.register_kernel("cuda")
def _beam_search_launch(logprobas, logit_length, blank, beam_width, max_length,
                        merge_repeats):
    """Launch csrc/beam_search.cu: its workspace in shared memory where the
    card gives a CTA ``_build.SMEM_BYTES["beam_search"]`` (the staged route),
    else in a global scratch row of that many bytes a row; the back-pointers
    [B, T, K] (pool index, slot) in a global scratch."""
    num_b, num_t, vocab = logprobas.shape
    dev = logprobas.device
    check_tensor(logprobas, (num_b, num_t, vocab), torch.float32, "logprobas", dev)
    check_tensor(logit_length, (num_b,), torch.int64, "logit_length", dev)
    check_tensor(blank, (), torch.int64, "blank", dev)
    staged = _build.fits(("beam_search",), vocab, beam_width, dev)
    row = _build.SMEM_BYTES["beam_search"](vocab, beam_width)
    gws = torch.empty(0 if staged else num_b * row, dtype=torch.uint8, device=dev)
    pointers = torch.empty((num_b, num_t, beam_width, 2), dtype=torch.int32, device=dev)
    tokens = torch.empty((num_b, beam_width, max_length), dtype=torch.int32, device=dev)
    lengths = torch.empty((num_b, beam_width), dtype=torch.int32, device=dev)
    scores = torch.empty((num_b, beam_width), device=dev)
    kernel = classic_beam_search if merge_repeats else simplified_beam_search
    _build.launch("beam_search", "ctc_beam_search", kernel.__name__, dev, logprobas,
                  logit_length, blank, num_b, num_t, vocab, beam_width, max_length,
                  int(merge_repeats), int(staged), gws, pointers, tokens, lengths, scores)
    if num_b:
        kernel.launches += 1
    return tokens, lengths, scores


# ---------------------------------------------------------------------------
# the scores' gradient
# ---------------------------------------------------------------------------
#
# Autograd through the loop sums over the beams and over the vocabulary
# where the loop broadcasts (``sum_to``).  torch's CPU sum kernel (ATen's
# SumKernel.cpp) adds in an order fixed by the layout: ``cascade_sum`` (its
# multi_row_sum) from zero in blocks of 16, ``ilp_sum`` (its row_sum) in four
# partial sums, and over a contiguous axis at least a vector wide those
# partials as vectors of SUM_LANES floats, then the lanes in order.  The
# plain backward adds in those orders on every device, and the kernel too.

# float32 lanes of the vectors of torch's CPU sum kernel: 8, on an AVX512
# host too (tests/test_torch_port_beam_grad.py holds these orders to
# torch.sum)
SUM_LANES = 8


def _ceil_log2(n: int) -> int:
    return 1 if n <= 2 else (n - 1).bit_length()


def cascade_sum(parts):
    """``parts`` (a non-empty list of tensors of one shape) summed as ATen's
    ``multi_row_sum`` sums rows: from zero into the first of four levels,
    each full block of ``2^p`` (p at least 4) added into the next level up,
    the levels added into the first at the end."""
    power = max(4, _ceil_log2(len(parts)) // 4)
    step, mask = 1 << power, (1 << power) - 1
    zero = torch.zeros_like(parts[0])
    acc = [zero] * 4
    i = 0
    while i + step <= len(parts):
        for part in parts[i:i + step]:
            acc[0] = acc[0] + part
        i += step
        for j in range(1, 4):
            acc[j], acc[j - 1] = acc[j] + acc[j - 1], zero
            if i & (mask << (j * power)):
                break
    for part in parts[i:]:
        acc[0] = acc[0] + part
    for j in range(1, 4):
        acc[0] = acc[0] + acc[j]
    return acc[0]


def ilp_sum(parts):
    """``parts`` summed as ATen's ``row_sum`` sums a row: part ``4i + p`` of
    the whole groups of four into partial p (:func:`cascade_sum`), the rest
    into partial 0, then ``((p0 + p1) + p2) + p3``."""
    whole = len(parts) // 4
    zero = torch.zeros_like(parts[0])
    sums = [cascade_sum(parts[p:4 * whole:4]) if whole else zero for p in range(4)]
    for part in parts[4 * whole:]:
        sums[0] = sums[0] + part
    return ((sums[0] + sums[1]) + sums[2]) + sums[3]


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over its last axis, contiguous, as torch's CPU sum does:
    below SUM_LANES elements :func:`ilp_sum`; else the whole vectors of
    SUM_LANES by :func:`ilp_sum`, and from zero the tail's elements, then
    the vector's lanes, in order."""
    n, lanes = x.shape[-1], SUM_LANES
    if n < lanes:
        return ilp_sum(list(x.unbind(-1)))
    vecs = n // lanes
    acc = ilp_sum(list(x[..., :vecs * lanes].unflatten(-1, (vecs, lanes)).unbind(-2)))
    out = torch.zeros_like(x[..., 0])
    for q in range(vecs * lanes, n):
        out = out + x[..., q]
    for lane in acc.unbind(-1):
        out = out + lane
    return out


def beam_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K, V] (contiguous) summed over its K axis, as torch's CPU
    sum does: columns in whole groups of four vectors of SUM_LANES (of four
    columns below SUM_LANES columns) by :func:`cascade_sum`, the other
    columns by :func:`ilp_sum`; a single column is a contiguous axis
    (:func:`lane_sum`)."""
    vocab = x.shape[-1]
    if vocab == 1:
        return lane_sum(x[..., 0])[..., None]
    rows = list(x.unbind(-2))
    group = 4 * SUM_LANES if vocab >= SUM_LANES else 4
    cut = vocab // group * group
    parts = []
    if cut:
        parts.append(cascade_sum([r[..., :cut] for r in rows]))
    if cut < vocab:
        parts.append(ilp_sum([r[..., cut:] for r in rows]))
    return torch.cat(parts, dim=-1)


def logsumexp_grad(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, x_first=0.0,
                   y_first=0.0):
    """The gradients of ``utils/numerics.py:logsumexp(x, y)`` under ``g``,
    as autograd takes them, operation for operation: none through a tie of
    infinities; log1p's ``g / (e + 1)``, exp's product by ``e``; the max's
    share ``g - d``, the min's ``d``; ``torch.maximum`` and ``minimum`` halve
    a share at a tie.  Each argument's adjoint adds in the order autograd's
    engine runs the nodes: an adjoint from a later use of the argument
    (``x_first``, ``y_first``) first, then the min's share, then the max's
    (``numerics.logsumexp`` passes ``x`` and ``y`` themselves to both when
    their shapes agree)."""
    special = (torch.isneginf(x) & torch.isneginf(y)) | (torch.isposinf(x)
                                                        & torch.isposinf(y))
    g_out = torch.where(special, 0.0, g)
    mx, mn = torch.maximum(x, y), torch.minimum(x, y)
    e = torch.exp(torch.where(special, 0.0, mn) - torch.where(special, 0.0, mx))
    g_diff = g_out / (e + 1) * e
    g_mx = torch.where(special, 0.0, g_out) + torch.where(special, 0.0, -g_diff)
    g_mn = torch.where(special, 0.0, g_diff)
    tie = x == y
    half_mx, half_mn = torch.where(tie, g_mx / 2, g_mx), torch.where(tie, g_mn / 2, g_mn)
    return ((x_first + half_mn.masked_fill(x > y, 0.0)) + half_mx.masked_fill(x < y, 0.0),
            (y_first + half_mn.masked_fill(x < y, 0.0)) + half_mx.masked_fill(x > y, 0.0))


def beam_search_grad(logprobas: torch.Tensor, logit_length: torch.Tensor,
                     blank: torch.Tensor, beam_width: int, max_length: int,
                     merge_repeats: bool, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`beam_search`'s scores in ``logprobas`` under
    the cotangent ``grad`` [B, K]: ``d_logprobas`` [B, T, V] float32, the
    gradient autograd takes through :func:`beam_search_plain`.

    The op ``ctc_port::beam_search_grad`` over the forward op's arguments
    and ``grad``: CUDA tensors launch csrc/beam_search.cu once (the kernels
    ``classic_beam_search_grad`` and ``simplified_beam_search_grad``); CPU
    tensors run :func:`beam_search_grad_plain`.  Its own derivative (a
    second derivative of the score) runs the plain version again."""
    return _beam_search_grad(logprobas, logit_length, blank, beam_width, max_length,
                             merge_repeats, grad.to(torch.float32).contiguous())


def _merge_grad(m: _Merge, g_pb: torch.Tensor, g_pnb: torch.Tensor) -> torch.Tensor:
    """The adjoints of a frame's pool ``(pb, pnb)`` [B, n, 2] in pool order
    from those of its selected beams [B, K]: each head's share of its run's
    segment logsumexp (utils/numerics.py:unsorted_segment_logsumexp), ``g /
    sum * exp(x - max)`` for every member, none from a run left empty, the
    max held constant; non-heads pass nothing on."""
    num_b, n_cand = m.order.shape
    ids = m.flat_seg
    g_rep = torch.stack([torch.zeros_like(m.order, dtype=g_pb.dtype).scatter_add(1, m.top, g)
                         for g in (g_pb, g_pnb)], dim=2)
    g_rep = torch.where(m.new_run[..., None], g_rep, 0.0).reshape(-1, 2)
    idx = ids[:, None].expand_as(m.sorted_p)
    data_max = torch.full_like(m.sorted_p, NEG_INF).scatter_reduce(
        0, idx, m.sorted_p.detach(), "amax")
    data_max_safe = torch.where(torch.isfinite(data_max), data_max, 0.0)
    ex = torch.exp(m.sorted_p - data_max_safe.index_select(0, ids))
    sums = torch.zeros_like(ex).index_add(0, ids, ex)
    empty = sums == 0.0
    g_merged = torch.zeros_like(g_rep).index_add(0, ids, g_rep)
    g_sums = torch.where(empty, 0.0, torch.where(empty, 0.0, g_merged)
                         / torch.where(empty, 1.0, sums))
    g_sorted = (g_sums.index_select(0, ids) * ex).reshape(num_b, n_cand, 2)
    return torch.zeros_like(g_sorted).scatter_add(
        1, m.order[..., None].expand(-1, -1, 2), g_sorted)


def _frame_grad(state, m: _Merge, lp_t, live, blank, l_cap: int, merge_repeats: bool,
                g_pb, g_pnb):
    """One frame of :func:`beam_search_grad_plain`'s reverse chain: from the
    adjoints of the frame's selected beams ``(g_pb, g_pnb)`` [B, K], those
    of its parent beams and the frame's ``d_logprobas`` [B, V], in
    autograd's order through :func:`_pool` (the sums over beams and tokens
    in torch's CPU order: :func:`ilp_sum` over the stays' strided adjoints,
    :func:`beam_sum`, :func:`lane_sum`; the scatter of ``last_lp``'s
    adjoints in beam order)."""
    _, length, last, _, _, pb, pnb = state
    num_b, k = pb.shape
    vocab = lp_t.shape[1]
    tok_ids = torch.arange(vocab, device=lp_t.device)
    g_pool = _merge_grad(m, g_pb, g_pnb).reshape(num_b, k, 1 + vocab, 2)
    g_stay_pb, g_stay_pnb = g_pool[:, :, 0, 0], g_pool[:, :, 0, 1]
    dead = ((tok_ids == blank)[None, None, :] | (length >= l_cap)[..., None]
            | ~live[:, None, None])
    g_ext = torch.where(dead, 0.0, g_pool[:, :, 1:, 1])  # [B, K, V]
    g_tok = beam_sum(g_ext)
    if merge_repeats:
        is_last = tok_ids == last[..., None]
        g_tot = g_stay_pb + lane_sum(torch.where(is_last, 0.0, g_ext))
        g_pb, g_pnb = logsumexp_grad(pb, pnb, g_tot,
                                     lane_sum(torch.where(is_last, g_ext, 0.0)),
                                     g_stay_pnb)
        # gather's adjoint: scatter_add, beam by beam as on the CPU (on the
        # card scatter_add adds in no fixed order)
        g_last = torch.where(last >= 0, g_stay_pnb, 0.0)
        at = torch.clamp(last, min=0)
        scattered = torch.zeros_like(g_tok)
        for q in range(k):
            scattered = scattered + torch.where(tok_ids == at[:, q, None], g_last[:, q, None],
                                                0.0)
        g_tok = g_tok + scattered
    else:
        g_tot = g_stay_pb + lane_sum(g_ext)
        g_pb, g_pnb = logsumexp_grad(pb, pnb, g_tot)
    g_blank = torch.where(live, ilp_sum(list(g_stay_pb.unbind(1))), 0.0)
    g_lp = (torch.where(live[:, None], g_tok, 0.0)
            + torch.zeros_like(g_tok).index_add(1, blank.reshape(1), g_blank[:, None]))
    return g_pb, g_pnb, g_lp


def beam_search_grad_plain(logprobas: torch.Tensor, logit_length: torch.Tensor,
                           blank: torch.Tensor, beam_width: int, max_length: int,
                           merge_repeats: bool, grad: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernels ``classic_beam_search_grad`` and
    ``simplified_beam_search_grad``, out of place: the loop's frames again
    (:func:`_pool`, :func:`_merge`), keeping each frame's parent beams and
    merge, then the reverse chain from the last frame down.  The final
    scores' adjoints are ``grad`` through the stable re-sort, then
    :func:`logsumexp_grad`; each frame passes them through its merge and
    pool (:func:`_frame_grad`).  A frame past a row's ``logit_length``
    gives its log-probabilities nothing.  Bit for bit autograd through
    :func:`beam_search_plain` on CPU tensors; differentiable itself."""
    num_b, num_t, vocab = logprobas.shape
    state = _initial_beams(num_b, beam_width, 0, logprobas.device)
    frames = []
    for t in range(num_t):
        live = t < logit_length
        c_length, c_last, c_h1, c_h2, c_p = _pool(state, logprobas[:, t], live, blank,
                                                  max_length, merge_repeats)
        m = _merge(c_h1, c_h2, c_p, beam_width)
        frames.append((state, m, live))
        sel = torch.gather(m.order, 1, m.top)
        state = (None, torch.gather(c_length, 1, sel), torch.gather(c_last, 1, sel),
                 torch.gather(c_h1, 1, sel), torch.gather(c_h2, 1, sel), m.pb, m.pnb)
    pb, pnb = state[5], state[6]
    score = _lse(pb, pnb)
    order = torch.argsort(-score, dim=1, stable=True)
    g_pb, g_pnb = logsumexp_grad(pb, pnb, torch.zeros_like(score).scatter_add(1, order, grad))
    d_lp = []
    for t in range(num_t - 1, -1, -1):
        state, m, live = frames[t]
        g_pb, g_pnb, g_lp = _frame_grad(state, m, logprobas[:, t], live, blank, max_length,
                                        merge_repeats, g_pb, g_pnb)
        d_lp.append(g_lp)
    if not num_t:
        return torch.zeros_like(logprobas)
    return torch.stack(d_lp[::-1], dim=1)


_beam_search_grad_op = kernel_op("beam_search_grad", beam_search_grad_plain)
register_fold(_beam_search_grad_op, (0, 0, None, None, None, None, 0), (0,))
_beam_search_grad = plain_grad("beam_search_grad", beam_search_grad_plain, (0, 6), (0,))
_beam_search = op_with_grad(
    "beam_search", (0,), lambda args, grads: (beam_search_grad(*args, grads[2]),))


@_beam_search_grad_op.register_fake
def _beam_search_grad_fake(logprobas, logit_length, blank, beam_width, max_length,
                           merge_repeats, grad):
    return torch.empty_like(logprobas)


def classic_beam_search_grad(logprobas: torch.Tensor, logit_length: torch.Tensor,
                             blank: torch.Tensor, beam_width: int, max_length: int,
                             grad: torch.Tensor) -> torch.Tensor:
    """The kernel ``classic_beam_search_grad``: the backward op with
    ``merge_repeats``.  ``.launches`` counts its launches."""
    return beam_search_grad(logprobas, logit_length, blank, beam_width, max_length, True,
                            grad)


def simplified_beam_search_grad(logprobas: torch.Tensor, logit_length: torch.Tensor,
                                blank: torch.Tensor, beam_width: int, max_length: int,
                                grad: torch.Tensor) -> torch.Tensor:
    """The kernel ``simplified_beam_search_grad``: the backward op without
    ``merge_repeats``."""
    return beam_search_grad(logprobas, logit_length, blank, beam_width, max_length, False,
                            grad)


classic_beam_search_grad.launches = 0
simplified_beam_search_grad.launches = 0


@_beam_search_grad_op.register_kernel("cuda")
def _beam_search_grad_launch(logprobas, logit_length, blank, beam_width, max_length,
                             merge_repeats, grad):
    """Launch csrc/beam_search.cu's backward: the forward's frames again in
    the forward's workspace (shared memory or a global row, as
    :func:`_beam_search_launch`), each frame's record of its parent beams
    and selected runs [B, T, K, 7] in a global scratch, then the reverse
    chain in the same workspace."""
    num_b, num_t, vocab = logprobas.shape
    dev = logprobas.device
    check_tensor(logprobas, (num_b, num_t, vocab), torch.float32, "logprobas", dev)
    check_tensor(logit_length, (num_b,), torch.int64, "logit_length", dev)
    check_tensor(blank, (), torch.int64, "blank", dev)
    check_tensor(grad, (num_b, beam_width), torch.float32, "grad", dev)
    staged = _build.fits(("beam_search",), vocab, beam_width, dev)
    row = _build.SMEM_BYTES["beam_search"](vocab, beam_width)
    gws = torch.empty(0 if staged else num_b * row, dtype=torch.uint8, device=dev)
    record = torch.empty((num_b, num_t, beam_width, 7), dtype=torch.int32, device=dev)
    d_lp = torch.empty_like(logprobas)
    kernel = classic_beam_search_grad if merge_repeats else simplified_beam_search_grad
    _build.launch("beam_search", "ctc_beam_search_grad", kernel.__name__, dev, logprobas,
                  logit_length, blank, grad, num_b, num_t, vocab, beam_width, max_length,
                  int(merge_repeats), int(staged), gws, record, d_lp)
    if num_b:
        kernel.launches += 1
    return d_lp


# ---------------------------------------------------------------------------
# a plain model of the kernel's steps, for the tests
# ---------------------------------------------------------------------------


def selection_key(score: torch.Tensor) -> torch.Tensor:
    """csrc/beam_search.cu's selection key of the candidates ``score`` [B, n]
    at sorted positions 0..n-1, as int64 in the same order (the kernel's
    uint64 less 2^63): the score mapped to an unsigned order (a NaN above
    +inf, -0 as +0), then the position reversed.  The largest key is the
    highest score, the lowest position among equal scores:
    ``torch.sort(score, descending=True, stable=True)``'s order."""
    pos = torch.arange(score.shape[1], device=score.device)
    bits = (score + 0.0).view(torch.int32).to(torch.int64) & _MASK32
    u = torch.where(bits >= _BIT31, bits ^ _MASK32, bits | _BIT31)
    u = torch.where(torch.isnan(score), _MASK32, u)
    return (u - _BIT31) * (1 << 32) + (_MASK32 - pos)


def _merge_runs(sorted_p: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The kernel's merge over the pool's ``(pb, pnb)`` in sorted order,
    ``sorted_p`` [B, n, 2], and its runs' heads ``head`` [B, n]: at each head the run's segment logsumexp of each component as
    ``unsorted_segment_logsumexp`` computes it, its members summed from the
    head on, in pool-index order; -inf elsewhere.  ``exp`` and ``log`` run
    on tensors laid out as the loop's (by sorted position, then by run), so
    that each element takes the same CPU code path as there."""
    num_b, n_cand, _ = sorted_p.shape
    run = torch.cumsum(head.to(torch.int64), dim=1) - 1
    by_run = run[..., None].expand(-1, -1, 2)
    m = torch.full_like(sorted_p, NEG_INF).scatter_reduce(1, by_run, sorted_p, "amax")
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(sorted_p - torch.gather(m_safe, 1, by_run))
    pos = torch.arange(n_cand, device=sorted_p.device)
    sums = torch.zeros_like(sorted_p)
    for j in range(n_cand):  # the j-th member of each run, from its head
        q = torch.clamp(pos + j, max=n_cand - 1).expand(num_b, -1)
        member = head & (pos + j < n_cand) & (torch.gather(run, 1, q) == run)
        if not bool(member.any()):
            break
        sums = sums + torch.where(member[..., None],
                                  torch.gather(e, 1, q[..., None].expand(-1, -1, 2)), 0.0)
    # the heads' sums by run, as the loop's segments
    slot = torch.where(head, run, n_cand)[..., None].expand(-1, -1, 2)
    seg = torch.zeros((num_b, n_cand + 1, 2), dtype=sorted_p.dtype, device=sorted_p.device)
    seg = seg.scatter_add(1, slot, torch.where(head[..., None], sums, 0.0))
    seg = seg[:, :n_cand].contiguous()
    empty = seg == 0.0
    safe_log = torch.log(torch.where(empty, torch.ones_like(seg), seg))
    merged = m_safe + torch.where(empty, torch.full_like(safe_log, NEG_INF), safe_log)
    return torch.where(head[..., None], torch.gather(merged, 1, by_run), NEG_INF)


def _ranks(score: torch.Tensor) -> torch.Tensor:
    """Each beam's place in a stable argsort of ``-score`` [B, K], as the
    kernel counts it: the beams before it (a number before a NaN), and the
    tied ones of lower index."""
    x = -score
    y, z = x[:, :, None], x[:, None, :]  # [b, q, j]: beam q against beam j
    before = (y < z) | (~torch.isnan(y) & torch.isnan(z))
    after = (z < y) | (~torch.isnan(z) & torch.isnan(y))
    iota = torch.arange(score.shape[1], device=score.device)
    lower = iota[:, None] < iota[None, :]
    return (before | (lower & ~after)).sum(dim=1)


def _backtrack(pointers, num_b: int, k: int, l_cap: int, width: int,
               device) -> torch.Tensor:
    """The tokens [B, K, Lcap] of the last frame's beams from the
    back-pointers ``(pool index, slot written or -1)`` [B, K] of each frame:
    going back from the last frame, the first write met for a slot stands;
    a slot never written is 0."""
    out = torch.full((num_b, k, l_cap), -1, dtype=torch.int64, device=device)
    beam = torch.arange(k, device=device).expand(num_b, k)
    for sel, slot in (reversed(pointers) if l_cap else ()):
        i = torch.gather(sel, 1, beam)
        at = torch.gather(slot, 1, beam)
        where = torch.clamp(at, min=0)[..., None]
        held = torch.gather(out, 2, where)[..., 0]
        write = (at >= 0) & (held < 0)
        out.scatter_(2, where, torch.where(write, i % width - 1, held)[..., None])
        beam = i // width
    return torch.where(out < 0, 0, out)


def beam_search_schedule(logprobas: torch.Tensor, logit_length: torch.Tensor,
                         blank: torch.Tensor, beam_width: int, max_length: int,
                         merge_repeats: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                                       torch.Tensor]:
    """A plain model of csrc/beam_search.cu's steps, for the tests, on the
    arguments of :func:`beam_search_plain`, whose outputs it writes bit for
    bit.  A frame pools the candidates as the loop does (:func:`_pool`),
    sorts them by the unique key ``(h1, h2, pool index)``, lets each run's
    head merge its members (:func:`_merge_runs`), takes the K largest
    selection keys (:func:`selection_key`) and keeps each beam's state and
    a back-pointer (pool index, slot written or -1), no tokens.  At the end
    the beams are ranked (:func:`_ranks`) and their tokens backtracked
    (:func:`_backtrack`)."""
    num_b, num_t, vocab = logprobas.shape
    k, l_cap, width = beam_width, max_length, 1 + vocab
    device = logprobas.device
    state = _initial_beams(num_b, k, 0, device)
    pointers = []
    for t in range(num_t):
        c_length, c_last, c_h1, c_h2, c_p = _pool(state, logprobas[:, t], t < logit_length,
                                                  blank, l_cap, merge_repeats)
        # (h1, h2) as one int64 in their unsigned order; a stable sort puts
        # the pool index on ties
        s_key, order = torch.sort((c_h1 - _BIT31) * (1 << 32) + c_h2, dim=1, stable=True)
        head = torch.ones_like(order, dtype=torch.bool)
        head[:, 1:] = s_key[:, 1:] != s_key[:, :-1]
        merged = _merge_runs(torch.gather(c_p, 1, order[..., None].expand(-1, -1, 2)),
                             head)
        m_pb, m_pnb = merged[..., 0], merged[..., 1]
        top = torch.topk(selection_key(_lse(m_pb, m_pnb)), k, dim=1).indices
        sel = torch.gather(order, 1, top)
        slot = torch.clamp(torch.gather(state[1], 1, sel // width), max=l_cap - 1)
        pointers.append((sel, torch.where((sel % width > 0) & (l_cap > 0), slot, -1)))
        state = (None, torch.gather(c_length, 1, sel), torch.gather(c_last, 1, sel),
                 torch.gather(c_h1, 1, sel), torch.gather(c_h2, 1, sel),
                 torch.gather(m_pb, 1, top), torch.gather(m_pnb, 1, top))
    _, length, _, _, _, pb, pnb = state
    score = _lse(pb, pnb)
    rank = _ranks(score)
    tokens = _backtrack(pointers, num_b, k, l_cap, width, device)
    at = rank[..., None].expand(-1, -1, l_cap)
    return (torch.empty_like(tokens).scatter_(1, at, tokens).to(torch.int32),
            torch.empty_like(length).scatter_(1, rank, length).to(torch.int32),
            torch.empty_like(score).scatter_(1, rank, score))
