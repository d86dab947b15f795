"""TextGenerationTransformer: a decoder-only token LM.

Counterpart of ``deeplearning4j_tpu/zoo/transformer.py``, the same
graph with the same vertex names: pre-LN blocks
(LN → causal multi-head SelfAttentionLayer → residual add →
LN → position-wise FFN as two kernel-1 Convolution1D layers → residual
add) over one-hot ``[N, V, T]`` input, an RnnOutputLayer softmax head,
Adam(3e-4) by default. Positions are a learned table
(``PositionalEmbeddingLayer``, the default) or rope; sliding windows
come later (ROADMAP.md A6).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    Convolution1DLayer, LayerNormalization, PositionalEmbeddingLayer,
    RnnOutputLayer, SelfAttentionLayer)
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.updater import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel

__all__ = ["TextGenerationTransformer"]


class TextGenerationTransformer(ZooModel):
    """The JAX zoo model's constructor. ``block_size`` is kept in the
    attention confs for parity; the flash-attention kernels pick their
    own tiles, as the JAX package's kernel path does. ``updater``
    defaults to ``Adam(3e-4)``."""

    def __init__(self, vocab_size: int = 128, seed: int = 12345,
                 embed_dim: int = 256, n_heads: int = 8, n_layers: int = 4,
                 ffn_mult: int = 4, max_length: int = 1024,
                 block_size: int = 512, positional: str = "learned",
                 n_kv_heads=None, window=None, updater=None, **kw):
        super().__init__(vocab_size, seed, **kw)
        if embed_dim % n_heads:
            raise ValueError("embed_dim must divide by n_heads")
        if positional not in ("learned", "rope"):
            raise ValueError(f"unknown positional {positional!r}")
        if window is not None:
            raise NotImplementedError(
                "sliding-window attention is not ported yet "
                "(ROADMAP.md A6)")
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.ffn_mult = ffn_mult
        self.max_length = max_length
        self.block_size = block_size
        self.positional = positional
        self.updater = updater if updater is not None else Adam(3e-4)
        self.n_kv_heads = n_kv_heads
        self.window = window

    def conf(self):
        E = self.embed_dim
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater)
             .weight_init("xavier")
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.recurrent(self.vocab_size,
                                                  self.max_length)))
        # token projection: one-hot [N,V,T] -> [N,E,T]
        g.add_layer("embed", Convolution1DLayer(
            n_out=E, kernel=1, activation="identity"), "in")
        if self.positional == "learned":
            g.add_layer("pos", PositionalEmbeddingLayer(
                max_length=self.max_length), "embed")
            prev = "pos"
        else:   # rope: positions enter inside attention, no table
            prev = "embed"
        for i in range(self.n_layers):
            g.add_layer(f"ln{i}a", LayerNormalization(), prev)
            g.add_layer(f"attn{i}", SelfAttentionLayer(
                n_out=E, n_heads=self.n_heads, causal=True,
                block_size=self.block_size, activation="identity",
                cache_length=self.max_length,
                n_kv_heads=self.n_kv_heads, window=self.window,
                rope=self.positional == "rope"), f"ln{i}a")
            g.add_vertex(f"res{i}a", ElementWiseVertex(op="add"),
                         prev, f"attn{i}")
            g.add_layer(f"ln{i}b", LayerNormalization(), f"res{i}a")
            g.add_layer(f"ffn{i}a", Convolution1DLayer(
                n_out=E * self.ffn_mult, kernel=1, activation="gelu"),
                f"ln{i}b")
            g.add_layer(f"ffn{i}b", Convolution1DLayer(
                n_out=E, kernel=1, activation="identity"), f"ffn{i}a")
            g.add_vertex(f"res{i}b", ElementWiseVertex(op="add"),
                         f"res{i}a", f"ffn{i}b")
            prev = f"res{i}b"
        g.add_layer("ln_f", LayerNormalization(), prev)
        g.add_layer("out", RnnOutputLayer(
            n_out=self.vocab_size, loss="mcxent", activation="softmax"),
            "ln_f")
        return g.set_outputs("out").build()

    def sample_stream(self, net, seed_ids, steps: int,
                      vocab_size: int = None, rng=None,
                      temperature: float = 1.0, top_k: int = None,
                      top_p: float = None, stop_tokens=()):
        """KV-cache incremental decoding (``util/decoding.sample_stream``):
        prime once, then one single-position forward per token; draws on
        the host from ``rng`` (top_k=1 is greedy)."""
        from deeplearning4j_tpu_torch.util.decoding import sample_stream
        return sample_stream(net, seed_ids, steps,
                             vocab_size or self.vocab_size,
                             temperature=temperature, rng=rng,
                             max_length=self.max_length, top_k=top_k,
                             top_p=top_p, stop_tokens=stop_tokens)

    def speculative_sample(self, net, draft, seed_ids, steps: int,
                           gamma: int = 4, vocab_size: int = None,
                           rng=None, temperature: float = 1.0,
                           top_k: int = None, top_p: float = None,
                           prime_padded: bool = False, stop_tokens=()):
        """Speculative decoding (``util/decoding.speculative_sample``):
        ``draft`` proposes ``gamma`` tokens and this model verifies them
        in ONE forward; the target distribution is preserved exactly
        (top_k=1 is greedy ``sample_stream``'s tokens). ``draft`` is a
        same-vocabulary streaming net (typically a smaller
        TextGenerationTransformer) or a host proposer callable such as
        ``decoding.prompt_lookup_proposer()``."""
        from deeplearning4j_tpu_torch.util.decoding import speculative_sample
        return speculative_sample(net, draft, seed_ids, steps,
                                  vocab_size or self.vocab_size,
                                  gamma=gamma, temperature=temperature,
                                  rng=rng, max_length=self.max_length,
                                  top_k=top_k, top_p=top_p,
                                  prime_padded=prime_padded,
                                  stop_tokens=stop_tokens)

    def beam_search(self, net, seed_ids, steps: int, beam_width: int = 4,
                    vocab_size: int = None, prime_padded: bool = False,
                    stop_tokens=()):
        """Beam search on the streaming KV cache
        (``util/decoding.beam_search``: the beams ride the batch
        dimension, pruning gathers the dense caches). Returns (best
        token sequence, its log-probability)."""
        from deeplearning4j_tpu_torch.util.decoding import beam_search
        return beam_search(net, seed_ids, steps,
                           vocab_size or self.vocab_size,
                           beam_width=beam_width,
                           max_length=self.max_length,
                           prime_padded=prime_padded,
                           stop_tokens=stop_tokens)
