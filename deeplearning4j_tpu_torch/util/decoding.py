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
``reorder_stream_state``). Still to come (ROADMAP.md A7):
``speculative_sample`` with a model draft and
``speculative_beam_search``; ``sample_stream_batch``,
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
           "step_tokens", "stop_reason", "verify_tokens"]


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
