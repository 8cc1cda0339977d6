"""Counterpart of ``deeplearning4j_tpu/models/zoo.py``: the reference's
benchmark configurations as ready-made confs, built through the same
Builder API users see: the MLPs (BASELINE config #1 and the digits MLP)
and the sequence models (the char-LSTM and the attention char-LM); the
other zoo confs come with their layers.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration, \
    NeuralNetConfiguration


def mnist_mlp(hidden1: int = 500, hidden2: int = 300, lr: float = 0.1,
              num_iterations: int = 1, seed: int = 42) -> MultiLayerConfiguration:
    """3-layer MLP (784-h1-h2-10), BASELINE config #1."""
    return (
        NeuralNetConfiguration.Builder()
        .n_in(784).n_out(hidden1).activation_function("relu")
        .lr(lr).momentum(0.9).use_ada_grad(False)
        .num_iterations(num_iterations).seed(seed).weight_init("SIZE")
        .list(3)
        .override(1, n_in=hidden1, n_out=hidden2)
        .override(2, layer_type="OUTPUT", n_in=hidden2, n_out=10,
                  activation_function="softmax", loss_function="MCXENT")
        .pretrain(False).backward(True)
        .build()
    )


def digits_mlp(hidden: int = 128, lr: float = 0.1, num_iterations: int = 1,
               seed: int = 42) -> MultiLayerConfiguration:
    """MLP for the real 8x8 sklearn digits set (64-h-10), used by the
    real-data accuracy gates (datasets/fetchers.py digits_data)."""
    return (
        NeuralNetConfiguration.Builder()
        .n_in(64).n_out(hidden).activation_function("relu")
        .lr(lr).momentum(0.9).use_ada_grad(False)
        .num_iterations(num_iterations).seed(seed).weight_init("SIZE")
        .list(2)
        .override(1, layer_type="OUTPUT", n_in=hidden, n_out=10,
                  activation_function="softmax", loss_function="MCXENT")
        .pretrain(False).backward(True)
        .build()
    )


def char_attention_lm(vocab: int = 64, d_model: int = 64, n_heads: int = 4,
                      seed: int = 42, lr: float = 0.1,
                      num_iterations: int = 50) -> MultiLayerConfiguration:
    """Causal attention char-LM: DENSE embedding projection vocab→d_model,
    then a causal multi-head self-attention block whose decoder emits
    per-timestep vocab logits (same sequence-head contract as
    char_lstm)."""
    return (
        NeuralNetConfiguration.Builder()
        .lr(lr).seed(seed).activation_function("linear")
        .loss_function("MCXENT").num_iterations(num_iterations)
        .list(2)
        .override(0, layer_type="DENSE", n_in=vocab, n_out=d_model)
        .override(1, layer_type="ATTENTION", n_in=d_model, n_out=vocab,
                  n_heads=n_heads, causal=True)
        .pretrain(False).backward(True)
        .build()
    )


def char_lstm(vocab: int = 64, seed: int = 42,
              lr: float = 0.1) -> MultiLayerConfiguration:
    """Karpathy-style char LSTM (ref: nn/layers/recurrent/LSTM.java).

    Trainable end-to-end through MultiLayerNetwork.fit(): the LSTM head's
    decoder provides per-timestep logits; labels are (batch, time, vocab)
    next-char one-hots, scored with per-timestep softmax cross-entropy.
    Hidden size equals n_out (square decoder), matching the reference's
    LSTMParamInitializer (nn/params/LSTMParamInitializer.java:39-41).
    """
    return (
        NeuralNetConfiguration.Builder()
        .lr(lr).seed(seed).activation_function("tanh")
        .loss_function("MCXENT")
        .list(1)
        .override(0, layer_type="LSTM", n_in=vocab, n_out=vocab)
        .pretrain(False).backward(True)
        .build()
    )
