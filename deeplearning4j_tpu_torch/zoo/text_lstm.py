"""TextGenerationLSTM: a stacked GravesLSTM character model.

Counterpart of ``deeplearning4j_tpu/zoo/text_lstm.py``, the same
sequential network: ``layers`` GravesLSTM layers of ``hidden`` units
(peepholes, tanh) over one-hot ``[N, V, T]`` input, an RnnOutputLayer
softmax over the vocabulary, xavier weights, element-wise gradient
clipping at 1, truncated BPTT in chunks of ``max_length`` steps, and
``RmsProp(1e-2)`` unless ``updater`` says otherwise. Every LSTM layer
runs the recurrence kernels (``nn/layers/lstm_kernel.py``).
``sample_stream`` and ``beam_search`` generate through the stored-state
``rnn_time_step`` path (``util/decoding.py``); batched decoding waits
for masked streaming (ROADMAP.md A6).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.updater import RmsProp
from deeplearning4j_tpu_torch.zoo.base import ZooModel

__all__ = ["TextGenerationLSTM"]


class TextGenerationLSTM(ZooModel):
    """The JAX zoo model's constructor; ``updater`` defaults to
    ``RmsProp(1e-2)``."""

    def __init__(self, vocab_size: int = 77, seed: int = 12345,
                 hidden: int = 256, layers: int = 2, max_length: int = 40,
                 updater=None, **kw):
        super().__init__(vocab_size, seed, **kw)
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.max_length = max_length
        self.updater = updater if updater is not None else RmsProp(1e-2)

    def conf(self):
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater)
             .weight_init("xavier")
             .gradient_normalization("clipelementwiseabsolutevalue", 1.0)
             .list())
        for _ in range(self.layers):
            b.layer(GravesLSTM(n_out=self.hidden, activation="tanh"))
        b.layer(RnnOutputLayer(n_out=self.vocab_size, loss="mcxent",
                               activation="softmax"))
        return (b.set_input_type(InputType.recurrent(self.vocab_size,
                                                     self.max_length))
                .tbptt(self.max_length)
                .build())

    def sample_stream(self, net, seed_ids, steps: int, vocab_size: int = None,
                      rng=None, temperature: float = 1.0, top_k: int = None,
                      top_p: float = None, stop_tokens=()):
        """Temperature sampling through the stored-state ``rnn_time_step``
        path (``util/decoding.sample_stream``; unbounded length): the
        prompt primes the carried h / c in one unpadded chunk (what the
        JAX package's chunked or left-padded primes compute), then one
        single-position forward per new token, each draw on the host in
        numpy."""
        from deeplearning4j_tpu_torch.util.decoding import sample_stream
        return sample_stream(net, seed_ids, steps,
                             vocab_size or self.vocab_size,
                             temperature=temperature, rng=rng,
                             max_length=None, top_k=top_k, top_p=top_p,
                             stop_tokens=stop_tokens)

    def sample_stream_batch(self, *args, **kwargs):
        raise NotImplementedError(
            "batched decoding primes the prompts left-padded under a "
            "carried mask: it waits for masked streaming (ROADMAP.md A6)")

    def beam_search(self, net, seed_ids, steps: int, beam_width: int = 4,
                    vocab_size: int = None, prime_padded: bool = False,
                    stop_tokens=()):
        """Beam search over the stored-state ``rnn_time_step`` path
        (``util/decoding.beam_search``; the beams' h / c ride the batch
        dimension; unbounded length). Returns (best token sequence, its
        log-probability)."""
        from deeplearning4j_tpu_torch.util.decoding import beam_search
        return beam_search(net, seed_ids, steps,
                           vocab_size or self.vocab_size,
                           beam_width=beam_width, max_length=None,
                           prime_padded=prime_padded,
                           stop_tokens=stop_tokens)
