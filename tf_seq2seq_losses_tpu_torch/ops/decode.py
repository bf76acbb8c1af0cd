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
"""

from __future__ import annotations

from typing import Tuple

import torch

from tf_seq2seq_losses_tpu_torch.ops import _build
from tf_seq2seq_losses_tpu_torch.ops.cuda_lattice import (
    check_tensor,
    kernel_op,
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


def _frame(state, lp_t, live, blank, l_cap: int, merge_repeats: bool):
    """One frame of the batched prefix beam search."""
    tokens, length = state[0], state[1]
    num_b, k = length.shape
    vocab = lp_t.shape[1]
    n_cand = k * (1 + vocab)
    device = lp_t.device
    neg_inf = torch.full((), NEG_INF, device=device)
    c_length, c_last, c_h1, c_h2, c_p = _pool(state, lp_t, live, blank, l_cap,
                                              merge_repeats)

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
    sel = torch.gather(order, 1, top)

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
        torch.gather(rep_pb, 1, top),
        torch.gather(rep_pnb, 1, top),
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
    rows are independent.  The scores are differentiable: the op's
    backward runs the loop again (``cuda_lattice.plain_grad``)."""
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
_beam_search = plain_grad("beam_search", beam_search_plain, (0,), (2,))


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
