"""Decoding over the streaming ``rnn_time_step`` machinery.

Counterpart of ``deeplearning4j_tpu/util/decoding.py`` for what the
serving path needs: the host-side sampling rules (``filter_probs`` /
``draw``, numpy, so sampled streams compare token for token with the
JAX package's wherever the probabilities agree), priming, the one-token
decode step, the retirement rule, ``sample_stream``, and the engine's
speculation: the widened verify forward (``verify_tokens``), the
rejection walk (``accept_proposals``) and the draft-free
``prompt_lookup_proposer``; and single-prompt ``beam_search`` (the
beams ride the batch dimension, pruning gathers the carried state with
``reorder_stream_state``); the one-shot ``speculative_sample``, drafted
by a second streaming network or a host proposer, and
``speculative_beam_search``. Still to come: ``sample_stream_batch``,
``beam_search_batch`` and ``speculative_sample_batch`` prime a batch of
prompts left-padded under a carried key mask, which waits for masked
streaming (ROADMAP.md A6).

The network is a ``ComputationGraph`` (the transformer) or a
``MultiLayerNetwork`` (the text LSTM, whose carried state is each
layer's h / c): the vocabulary is the network input's size either way.

Priming feeds the whole prompt as ONE unpadded chunk. The JAX package
primes in power-of-two chunks or one left-padded bucket to bound its
jit shapes; packed (padded) priming equals unpadded priming by
construction, and eager PyTorch has no shapes to bound.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["accept_proposals", "beam_search", "draw", "filter_probs",
           "prime_prompt", "prompt_lookup_proposer", "sample_stream",
           "speculative_beam_search", "speculative_sample", "step_tokens",
           "stop_reason", "verify_tokens"]


def _vocab(net) -> int:
    """The network input's size: a sequential network's ``input_type``,
    a graph's first input type."""
    it = getattr(net.conf, "input_type", None)
    if it is None:
        it = next(iter(net.conf.input_types.values()))
    return it.size


def _one_hot(net, rows) -> torch.Tensor:
    """One-hot ``[B, V, T]`` float32 on the net's device, built there
    from the token ids (only the ids cross to the device)."""
    ids = torch.as_tensor(np.asarray(rows, np.int64), device=net.device)
    vocab = _vocab(net)
    x = torch.zeros((ids.shape[0], vocab, ids.shape[1]), device=net.device)
    return x.scatter_(1, ids[:, None, :], 1.0)


def _probs(out) -> np.ndarray:
    out = out[0] if isinstance(out, (list, tuple)) else out
    return out.float().cpu().numpy()


def filter_probs(probs, temperature, top_k=None, top_p=None) -> np.ndarray:
    """The sampling distribution actually drawn from: temperature
    rescales first, then ``top_k`` keeps exactly the k most probable
    tokens, then ``top_p`` keeps the smallest prefix of the sorted
    distribution whose mass reaches p (at least one token); survivors
    renormalize. One row ``[V]`` or a batch ``[B, V]`` (scalar
    parameters)."""
    probs = np.asarray(probs)
    if probs.ndim == 1:
        return _filter_rows(probs[None, :], temperature, top_k, top_p)[0]
    if probs.ndim != 2:
        raise ValueError(f"probs must be [V] or [B, V], got shape "
                         f"{probs.shape}")
    return _filter_rows(probs, temperature, top_k, top_p)


def _filter_rows(p2, temperature, top_k, top_p):
    B, V = p2.shape
    logits = np.log(np.clip(p2, 1e-9, None))
    logits = logits / np.asarray(temperature).astype(logits.dtype)
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    p = p / p.sum(axis=-1, keepdims=True)
    if top_k is not None:
        k = int(top_k)
        if k < 1:
            raise ValueError(f"top_k must be >= 1, got {k}")
        if k < V:
            # exactly k indices per row: partition out the top k, then
            # order only that slice
            part = np.argpartition(p, V - k, axis=-1)[:, V - k:]
            vals = np.take_along_axis(p, part, axis=-1)
            order = np.take_along_axis(
                part, np.argsort(vals, axis=-1)[:, ::-1], axis=-1)
            keep = np.zeros((B, V), bool)
            np.put_along_axis(keep, order, True, axis=-1)
            p = np.where(keep, p, 0.0)
            p = p / p.sum(axis=-1)[:, None]
    if top_p is not None:
        tp = float(top_p)
        if not 0.0 < tp <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {tp}")
        order = np.argsort(p, axis=-1)[:, ::-1]
        csum = np.cumsum(np.take_along_axis(p, order, axis=-1), axis=-1)
        # a sorted token survives iff the mass strictly before it is
        # under top_p
        before = np.concatenate([np.zeros((B, 1), csum.dtype),
                                 csum[:, :-1]], axis=1)
        keep = np.zeros((B, V), bool)
        np.put_along_axis(keep, order, before < tp, axis=-1)
        p = np.where(keep, p, 0.0)
        p = p / p.sum(axis=-1)[:, None]
    return p


def draw(probs, temperature, rng, top_k=None, top_p=None) -> int:
    """Sample one token id from a ``[V]`` distribution (see
    filter_probs; top_k=1 is greedy regardless of temperature)."""
    p = filter_probs(probs, temperature, top_k, top_p)
    return int(rng.choice(len(p), p=p))


def _check_seed(seed_ids, steps, max_length):
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if len(seed_ids) == 0:
        raise ValueError("seed_ids must contain at least one token")
    if max_length is not None and len(seed_ids) >= max_length:
        raise ValueError(f"seed of {len(seed_ids)} tokens leaves no room "
                         f"under max_length {max_length}")


def _stream_layers(net):
    """Every layer of a network (a graph's vertices' layers, a
    sequential network's layers) that may carry streaming state."""
    layers = getattr(net, "layers", None)
    if layers is not None:
        yield from layers
        return
    for v in net.conf.vertices.values():
        l = getattr(v, "layer", None)
        if l is not None:
            yield l


def prime_prompt(net, ids) -> np.ndarray:
    """Prefill: feed the whole prompt through the carried streaming state
    in one chunk and return the next-token distribution ``[V]``. Does
    NOT clear previous state: the caller owns the stream lifecycle."""
    return _probs(net.rnn_time_step(_one_hot(net, [list(ids)])))[0, :, -1]


def step_tokens(net, tokens) -> np.ndarray:
    """One incremental decode step for a batch of rows: one token per
    row in a single forward; returns the next-token distributions
    ``[B, V]``."""
    out = net.rnn_time_step(_one_hot(net, np.asarray(tokens)[:, None]))
    return _probs(out)[:, :, -1]


def verify_tokens(net, chunks) -> np.ndarray:
    """One widened verify forward for a batch of token chunks: feed
    ``chunks`` ``[B, W]`` (W = 1 + gamma for the engine's speculation) in
    one forward and return every position's next-token distribution
    ``[B, V, W]``: position j's is the distribution after consuming
    ``chunk[:, :j+1]``. Causality hides trailing dummy tokens from the
    positions before them, so one fixed width serves rows with fewer
    real proposals. Under the engine's paged view the chunk runs the
    paged append and the paged-attention kernel at query width W (the
    engine's own dispatch runs the same forward through
    ``rnn_time_step``'s device part, its decode graph's body)."""
    return _probs(net.rnn_time_step(_one_hot(net, np.asarray(chunks))))


def accept_proposals(proposals, p_dists, q_dists, p_bonus, rng
                     ) -> Tuple[int, int]:
    """The Leviathan et al. 2023 rejection walk (the JAX package's one
    acceptance rule): accept proposal i with probability min(1, p_i[d] /
    q_i[d]); at the first rejection draw the replacement from the
    clipped residual max(p_i - q_i, 0) (p_i when q subsumes p); with
    every proposal accepted draw the bonus token from ``p_bonus``.
    Returns ``(accepted, next_token)``: the committed tokens are
    ``proposals[:accepted] + [next_token]``, and the target's sampling
    distribution is preserved exactly.

    A ``q_dists`` entry of None is a deterministic proposer (a one-hot
    draft at the proposal): q_i[d] == 1, and the residual is p_i with
    entry d zeroed. The rng's consumption order is part of the
    contract: one uniform per walked proposal, then exactly one choice,
    so a request's rng draws as in the JAX package."""
    for i, d in enumerate(proposals):
        p_i, q_i = p_dists[i], q_dists[i]
        qd = 1.0 if q_i is None else float(q_i[d])
        if rng.random() < min(1.0, float(p_i[d]) / max(qd, 1e-12)):
            continue
        if q_i is None:
            resid = np.array(p_i)
            resid[d] = 0.0
        else:
            resid = np.maximum(p_i - q_i, 0.0)
        total = resid.sum()
        if total <= 0:            # p subsumed by q: fall back to p_i
            resid, total = p_i, p_i.sum()
        return i, int(rng.choice(len(resid), p=resid / total))
    return len(proposals), int(rng.choice(len(p_bonus), p=p_bonus))


def prompt_lookup_proposer(ngram: int = 3):
    """Draft-free speculation proposer (prompt-lookup decoding): propose
    the continuation of the most recent earlier occurrence of the
    context's trailing n-gram. It costs no device work, so it pays on a
    dispatch-bound serving path whenever generation revisits earlier
    text; elsewhere it proposes little. Pass the returned callable as
    ``SpeculationConfig(draft=...)``."""
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")

    def propose(ids, gamma):
        if len(ids) <= ngram:
            return []
        tail = list(ids[-ngram:])
        for s in range(len(ids) - ngram - 1, -1, -1):
            if list(ids[s:s + ngram]) == tail:
                return list(ids[s + ngram:s + ngram + gamma])
        return []

    return propose


def stop_reason(token: int, n_ids: int, want: int,
                stop_set) -> Optional[str]:
    """Why generation ends after appending `token` as the n_ids-th id
    (None = keep going). EOS wins over length when both hit."""
    if token in stop_set:
        return "stop"
    if n_ids >= want:
        return "length"
    return None


def sample_stream(net, seed_ids, steps: int, vocab_size: int,
                  temperature: float = 1.0,
                  rng: Optional[np.random.Generator] = None,
                  max_length: Optional[int] = None,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  stop_tokens=()) -> List[int]:
    """Sampling with KV-cache incremental decoding: prime once with the
    seed, then one single-position forward per generated token.
    Generation ends early when a ``stop_tokens`` member is drawn (kept
    as the final id)."""
    _check_seed(seed_ids, steps, max_length)
    vocab = _vocab(net)
    if vocab != vocab_size:
        raise ValueError(f"vocab_size {vocab_size} != the net's input "
                         f"size {vocab}")
    rng = rng or np.random.default_rng(0)
    stop_tokens = set(stop_tokens)
    ids = list(seed_ids)
    want = len(ids) + steps
    if max_length is not None:
        want = min(want, max_length)
    net.rnn_clear_previous_state()
    p = prime_prompt(net, ids)
    for i in range(steps):
        if max_length is not None and len(ids) >= max_length:
            break
        nxt = draw(p, temperature, rng, top_k=top_k, top_p=top_p)
        ids.append(nxt)
        if stop_reason(nxt, len(ids), want, stop_tokens):
            break
        if i + 1 < steps:
            p = step_tokens(net, [nxt])[0]
    return ids


def beam_search(net, seed_ids, steps: int, vocab_size: int,
                beam_width: int = 4,
                max_length: Optional[int] = None,
                prime_chunk_max: Optional[int] = None,
                prime_padded: bool = False,
                stop_tokens=()) -> Tuple[List[int], float]:
    """Highest-log-prob continuation of ``seed_ids`` by beam search (the
    JAX package's ``beam_search``): prime once at batch 1, broadcast the
    carried state to the W = min(beam_width, V) beams, then one W-row
    forward a step; pruning gathers the state by parent
    (``reorder_stream_state``), skipped when every beam keeps its own.
    The port primes in one unpadded chunk and has no width buckets, so
    the beam batch is W rows (the JAX package pads it to a power of
    two); ``prime_chunk_max`` and ``prime_padded`` are accepted and
    change nothing.

    ``stop_tokens``: a hypothesis that extends with a stop token
    FINISHES (keeps it as its final id and leaves its slot to live
    candidates); the search ends when every slot is finished, when no
    live hypothesis can still beat the best finished one (log-prob
    totals only fall as hypotheses extend), or when the step budget
    runs out. The best finished hypothesis wins (the best live one if
    nothing finished). Returns ``(sequence, log-probability)``."""
    from deeplearning4j_tpu_torch.nn.conf.layers import reorder_stream_state
    del prime_chunk_max, prime_padded   # one unpadded prime chunk
    _check_seed(seed_ids, steps, max_length)
    vocab = _vocab(net)
    if vocab != vocab_size:
        raise ValueError(f"vocab_size {vocab_size} != the net's input "
                         f"size {vocab}")
    V = vocab_size
    stop_tokens = set(stop_tokens)
    W = min(beam_width, V)     # top-k can't exceed the vocab
    net.rnn_clear_previous_state()
    p0 = prime_prompt(net, seed_ids)
    reorder_stream_state(net, np.zeros(W, np.int64))
    out = np.repeat(p0[None], W, axis=0)                      # [W, V]
    beams = [list(seed_ids) for _ in range(W)]
    scores = np.zeros(W)
    alive = np.ones(W, bool)   # slots still extending (EOS finishes one)
    finished = []              # (sequence, score) hypotheses that hit EOS
    first = True
    for i in range(steps):
        if max_length is not None and len(beams[0]) >= max_length:
            break
        logp = np.log(np.clip(out, 1e-12, None))               # [W, V]
        if first:
            # identical primed beams must diverge: top-W FIRST tokens of
            # beam 0, not W copies of the argmax
            top = np.argsort(logp[0])[::-1][:W]
            parents, tokens, scores = np.zeros(W, np.int64), top, \
                logp[0][top]
            first = False
            beams = [beams[p] + [int(t)] for p, t in zip(parents, tokens)]
            alive, stop_now = _beam_finish(tokens, scores, alive, beams,
                                           stop_tokens, finished, W)
        else:
            parents, tokens, scores, alive, beams, stop_now = \
                _beam_update(logp, scores, alive, beams, stop_tokens,
                             finished, W, V)
        if stop_now:
            break
        more = i + 1 < steps and (max_length is None
                                  or len(beams[0]) < max_length)
        if more:
            if not np.array_equal(parents, np.arange(W)):
                reorder_stream_state(net, parents)   # inherit caches
            out = step_tokens(net, np.array(tokens, np.int64))
    live = [(beams[w], float(scores[w])) for w in range(W)
            if alive[w] and np.isfinite(scores[w])]
    pool = finished if finished else live
    if not pool:
        pool = [(beams[w], float(scores[w])) for w in range(W)]
    best_seq, best_score = max(pool, key=lambda bs: bs[1])
    return best_seq, best_score


def _beam_finish(tokens, scores, alive, beams, stop_set, finished, W):
    """The finishing / early-stop tail of one beam step: EOS hypotheses
    move to ``finished`` and their slots die; the search is decided when
    nothing live can beat the best finished. Returns (alive, stop)."""
    stop = False
    if stop_set:
        alive = np.ones(W, bool)
        for w, t in enumerate(tokens):
            if int(t) in stop_set and np.isfinite(scores[w]):
                finished.append((beams[w], float(scores[w])))
                alive[w] = False
        if not alive.any():
            stop = True
        elif finished:
            best_fin = max(sc for _, sc in finished)
            if scores[alive].max() <= best_fin:
                stop = True
    return alive, stop


def _beam_update(logp, scores, alive, beams, stop_set, finished, W, V):
    """One beam-search scoring update: the totals (finished slots at
    -inf), the flat top W, then :func:`_beam_finish`. Returns (parents,
    tokens, scores, alive, beams, stop). ``scores`` keeps the log-probs'
    dtype (f32 from the net), as in the JAX package."""
    total = scores[:, None] + logp
    total[~alive] = -np.inf             # finished slots never extend
    flat = np.argsort(total.ravel())[::-1][:W]
    parents, tokens = np.divmod(flat, V)
    scores = total.ravel()[flat]
    beams = [beams[p] + [int(t)] for p, t in zip(parents, tokens)]
    alive, stop = _beam_finish(tokens, scores, alive, beams, stop_set,
                               finished, W)
    return parents, tokens, scores, alive, beams, stop


def _check_draft(draft, vocab: int) -> bool:
    """Whether ``draft`` is a host proposer callable (True) or a
    streaming network of the target's vocabulary (False)."""
    if not hasattr(draft, "rnn_time_step"):
        if not callable(draft):
            raise TypeError("draft must be a streaming net or a callable "
                            "(ids, gamma) -> proposals")
        return True
    if _vocab(draft) != vocab:
        raise ValueError(f"the draft's vocabulary {_vocab(draft)} != the "
                         f"target's {vocab}")
    return False


def speculative_sample(net, draft, seed_ids, steps: int, vocab_size: int,
                       gamma: int = 4, temperature: float = 1.0,
                       rng: Optional[np.random.Generator] = None,
                       max_length: Optional[int] = None,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None,
                       prime_padded: bool = False,
                       prime_chunk_max: Optional[int] = None,
                       stop_tokens=()) -> List[int]:
    """One-shot speculative decoding (the JAX package's
    ``speculative_sample``, the Leviathan et al. 2023 rejection scheme):
    ``draft`` proposes up to ``gamma`` tokens, the target ``net`` scores
    the pending token and every proposal in ONE forward, and
    :func:`accept_proposals` keeps the longest accepted prefix. The
    target's sampling distribution is preserved exactly; with top_k=1
    the tokens are greedy :func:`sample_stream`'s.

    ``draft`` is a same-vocabulary streaming network (each proposal a
    draw from its filtered distribution, one draft forward a proposal)
    or a host callable ``(ids, gamma) -> proposals`` such as
    :func:`prompt_lookup_proposer` (a one-hot draft). Both networks must
    rewind (:func:`check_rewindable`: the text LSTM refuses); after each
    round the rejected positions rewind on both. The committed token a
    round ends with rides the front of the next round's verify chunk
    instead of a dispatch of its own. ``temperature``, ``top_k`` and
    ``top_p`` filter the target's and the draft's distributions alike;
    generation ends at the first ``stop_tokens`` member committed (kept
    as the final id) or at ``max_length`` ids. The rng is consumed in
    the JAX package's order, so a sampled stream matches it token for
    token wherever the distributions agree.

    The port primes each network in one unpadded chunk:
    ``prime_padded`` and ``prime_chunk_max`` are accepted and change
    nothing."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        check_rewindable, rewind_stream_state)
    del prime_padded, prime_chunk_max   # one unpadded prime chunk
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    _check_seed(seed_ids, steps, max_length)
    V = _vocab(net)
    if V != vocab_size:
        raise ValueError(f"vocab_size {vocab_size} != the net's input "
                         f"size {V}")
    rng = rng or np.random.default_rng(0)
    ids = list(seed_ids)
    draft_is_fn = _check_draft(draft, V)
    # fail fast: a net that cannot rewind would fail only at the first
    # rejection, mid-generation
    check_rewindable(net, gamma)
    if not draft_is_fn:
        check_rewindable(draft, gamma)

    def filt(p):
        return filter_probs(p, temperature, top_k, top_p)

    net.rnn_clear_previous_state()
    # the target's filtered distribution of the NEXT token, given what
    # its cache has consumed
    p_next = filt(prime_prompt(net, ids))
    if not draft_is_fn:
        draft.rnn_clear_previous_state()
        q_next = filt(prime_prompt(draft, ids))
    want = len(seed_ids) + steps
    if max_length is not None:
        want = min(want, max_length)
    stop_set = set(stop_tokens)

    def stop_cut(start):
        """Index just past the first stop token at or after ``start``,
        or -1."""
        for j in range(start, len(ids)):
            if ids[j] in stop_set:
                return j + 1
        return -1

    # the committed, not yet consumed, last id rides the front of the
    # next verify chunk: every round is ONE target forward
    pending = None
    while len(ids) < want:
        g = min(gamma, want - len(ids))
        if draft_is_fn:
            proposals = [int(t) for t in draft(ids, g)][:g]
            g = len(proposals)
            q_dists = [None] * g       # a deterministic proposer
        else:
            proposals, q_dists = [], []
            if pending is not None:
                q_next = filt(step_tokens(draft, [pending])[0])
            q = q_next
            for _ in range(g):
                d = int(rng.choice(V, p=q))
                proposals.append(d)
                q_dists.append(q)
                q = filt(step_tokens(draft, [d])[0])
        chunk = ([] if pending is None else [pending]) + proposals
        if not chunk:                  # nothing proposed, nothing pending
            nxt = int(rng.choice(V, p=p_next))
            ids.append(nxt)
            if nxt in stop_set:
                return ids
            pending, p_next = nxt, None
            continue
        tp = verify_tokens(net, [chunk])[0]            # [V, len(chunk)]
        off = len(chunk) - g                           # 1 when pending rode
        if pending is not None:
            pending = None
            p_next = filt(tp[:, off - 1])
        if g == 0:                     # a plain step
            nxt = int(rng.choice(V, p=p_next))
            ids.append(nxt)
            if nxt in stop_set:
                return ids
            pending, p_next = nxt, None
            continue
        p_dists = [p_next] + [filt(tp[:, off + i]) for i in range(g - 1)]
        p_bonus = filt(tp[:, off + g - 1])
        accepted, nxt = accept_proposals(proposals, p_dists, q_dists,
                                         p_bonus, rng)
        base = len(ids)
        ids.extend(proposals[:accepted])
        ids.append(nxt)
        if stop_set:
            cut = stop_cut(base)
            if cut >= 0:
                # plain decoding stops at ``want`` before a later stop
                return ids[:min(cut, want)]
        pending, p_next = nxt, None
        rewind_stream_state(net, g - accepted)
        if not draft_is_fn:
            rewind_stream_state(draft, g - accepted)
    return ids[:want]


def speculative_beam_search(net, draft, seed_ids, steps: int,
                            vocab_size: int, beam_width: int = 4,
                            gamma: int = 4,
                            max_length: Optional[int] = None,
                            prime_chunk_max: Optional[int] = None,
                            stop_tokens=()) -> Tuple[List[int], float]:
    """Beam search accelerated by speculation (the JAX package's
    ``speculative_beam_search``): its (sequence, score) equal
    :func:`beam_search`'s, and the target runs once a round instead of
    once a step.

    ``draft`` proposes a continuation for every beam: a host proposer
    ``(ids, gamma) -> proposals`` (the round's depth is the shortest
    list), or a same-vocabulary streaming network, the beam-synchronized
    greedy model draft, which streams the same W-row batch and mirrors
    every feed, rewind and reorder (:func:`reorder_stream_state`), so
    its caches hold the committed beam prefixes. One batched target
    forward scores each beam's pending token and its proposals; the
    walk replays :func:`_beam_update` step by step from those
    distributions. A drafted step is accepted while the true update
    extends each beam with its own proposal (identity parents, the
    drafted tokens, nothing finishing); the first divergence applies the
    true update from the same forward, the uniform over-consumed tail
    rewinds, and the corrected tokens ride the next round as the
    pending front. A round with a finished slot drafts nothing (one
    corrected step).

    The beam batch is W = min(beam_width, V) rows, as in
    :func:`beam_search` (the JAX package pads it to a power of two;
    the result does not depend on it); ``prime_chunk_max`` is accepted
    and changes nothing."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        check_rewindable, reorder_stream_state, rewind_stream_state)
    del prime_chunk_max                 # one unpadded prime chunk
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    V = _vocab(net)
    if V != vocab_size:
        raise ValueError(f"vocab_size {vocab_size} != the net's input "
                         f"size {V}")
    draft_is_fn = _check_draft(draft, V)
    _check_seed(seed_ids, steps, max_length)
    check_rewindable(net, gamma)
    if not draft_is_fn:
        check_rewindable(draft, gamma)
    stop_set = set(stop_tokens)
    W = min(beam_width, V)
    net.rnn_clear_previous_state()
    logp0 = np.log(np.clip(prime_prompt(net, seed_ids), 1e-12, None))
    reorder_stream_state(net, np.zeros(W, np.int64))
    if not draft_is_fn:
        draft.rnn_clear_previous_state()
        prime_prompt(draft, seed_ids)
        reorder_stream_state(draft, np.zeros(W, np.int64))

    # the first expansion: beam_search's, the top-W first tokens of beam
    # 0 (f32 scores); they are round 1's pending front
    top = np.argsort(logp0)[::-1][:W]
    beams = [list(seed_ids) + [int(t)] for t in top]
    scores = logp0[top]
    alive = np.ones(W, bool)
    finished = []
    pending = top.astype(np.int64)      # [W] committed, not yet consumed
    committed = 1
    want = steps
    if max_length is not None:
        want = min(want, max_length - len(seed_ids))
    alive, stop_now = _beam_finish(top, scores, alive, beams, stop_set,
                                   finished, W)
    decided = committed >= want or stop_now

    while not decided:
        # a common depth for the collective acceptance: 0 is a
        # correction-only round, one dispatch a step (plain beam's rate)
        g = min(gamma, want - committed - 1)
        proposals = None
        if g > 0 and alive.all():
            if draft_is_fn:
                plists = [[int(t) for t in draft(beams[w], g)][:g]
                          for w in range(W)]
                g = min(len(p) for p in plists)
                if g > 0:
                    proposals = np.asarray([p[:g] for p in plists],
                                           np.int64)      # [W, g]
            else:
                # greedy: the pending front, then each argmax; the draft
                # consumes 1 + g tokens as the target does
                out_d = step_tokens(draft, pending)
                props = []
                for _ in range(g):
                    nxt = out_d.argmax(axis=1).astype(np.int64)
                    props.append(nxt)
                    out_d = step_tokens(draft, nxt)
                proposals = np.stack(props, axis=1)       # [W, g]
        if proposals is None:
            g = 0
            if not draft_is_fn:
                # the draft consumes the pending front all the same, to
                # stay at the target's positions
                step_tokens(draft, pending)
        chunk = np.zeros((W, 1 + g), np.int64)
        chunk[:, 0] = pending
        if g:
            chunk[:, 1:] = proposals
        tp = verify_tokens(net, chunk)                     # [W, V, 1+g]

        accepted = 0
        stop_now = False
        parents = tokens = None
        # committed + g + 1 <= want: every walk step is in the budget
        for j in range(g + 1):
            logp = np.log(np.clip(tp[:, :, j], 1e-12, None))
            parents, tokens, scores, alive, beams, stop_now = \
                _beam_update(logp, scores, alive, beams, stop_set,
                             finished, W, V)
            committed += 1
            if stop_now:
                break
            if j < g and np.array_equal(parents, np.arange(W)) \
                    and np.array_equal(tokens, proposals[:, j]) \
                    and alive.all():
                accepted += 1
                parents = tokens = None   # advanced as drafted
                continue
            break                         # a divergence, or the bonus

        # the over-consumed drafted tail, the same on every row
        over = g - accepted
        if over:
            rewind_stream_state(net, over)
            if not draft_is_fn:
                rewind_stream_state(draft, over)
        if committed >= want or stop_now:
            break
        # the walk ends on a true update: the caches follow the new
        # beam assignment and its tokens are the next pending front
        if not np.array_equal(parents, np.arange(W)):
            reorder_stream_state(net, parents)
            if not draft_is_fn:
                reorder_stream_state(draft, parents)
        pending = np.asarray(tokens, np.int64)

    live = [(beams[w], float(scores[w])) for w in range(W)
            if alive[w] and np.isfinite(scores[w])]
    pool = finished if finished else live
    if not pool:
        pool = [(beams[w], float(scores[w])) for w in range(W)]
    best_seq, best_score = max(pool, key=lambda bs: bs[1])
    return best_seq, best_score
