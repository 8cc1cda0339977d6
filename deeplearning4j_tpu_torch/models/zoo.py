"""Counterpart of ``deeplearning4j_tpu/models/zoo.py``: the reference's
benchmark configurations as ready-made confs, built through the same
Builder API users see, field for field the JAX package's: the MLPs
(BASELINE config #1 and the digits MLP), the conv nets (LeNet, BASELINE
config #2; the digits conv net; the wide conv stack), the stacked
denoising autoencoder (BASELINE config #3) and the sequence models (the
char-LSTM and the attention char-LM).
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


def lenet(lr: float = 0.05, num_iterations: int = 1, seed: int = 42
          ) -> MultiLayerConfiguration:
    """LeNet-5-style conv net for 28x28 MNIST, BASELINE config #2.

    conv5x6 → pool2 → conv5x16 → pool2 → dense120 → dense84 → softmax10
    (ref conv path: nn/layers/convolution/ConvolutionLayer.java:115-128,
    subsampling: SubsamplingLayer.java:114-155).
    """
    return (
        NeuralNetConfiguration.Builder()
        .lr(lr).momentum(0.9).use_ada_grad(False)
        .num_iterations(num_iterations).seed(seed)
        .weight_init("SIZE").activation_function("relu")
        .list(7)
        .override(0, layer_type="CONVOLUTION", n_in=1, n_out=6, filter_size=(5, 5))
        .override(1, layer_type="SUBSAMPLING", stride=(2, 2))
        .override(2, layer_type="CONVOLUTION", n_in=6, n_out=16, filter_size=(5, 5))
        .override(3, layer_type="SUBSAMPLING", stride=(2, 2))
        .override(4, layer_type="DENSE", n_in=16 * 4 * 4, n_out=120)
        .override(5, layer_type="DENSE", n_in=120, n_out=84)
        .override(6, layer_type="OUTPUT", n_in=84, n_out=10,
                  activation_function="softmax", loss_function="MCXENT")
        .input_preprocessor(0, "ff_to_conv")
        .input_preprocessor(4, "conv_to_ff")
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


def digits_conv(lr: float = 0.05, num_iterations: int = 1, seed: int = 42
                ) -> MultiLayerConfiguration:
    """Small conv net for 8x8 digits: conv3x16 → pool2 → dense64 → softmax10.

    Exercises the same conv→pool→dense path as LeNet (ref:
    nn/layers/convolution/ConvolutionLayer.java:115-128) on real data."""
    return (
        NeuralNetConfiguration.Builder()
        .lr(lr).momentum(0.9).use_ada_grad(False)
        .num_iterations(num_iterations).seed(seed)
        .weight_init("SIZE").activation_function("relu")
        .list(4)
        .override(0, layer_type="CONVOLUTION", n_in=1, n_out=16, filter_size=(3, 3))
        .override(1, layer_type="SUBSAMPLING", stride=(2, 2))
        .override(2, layer_type="DENSE", n_in=16 * 3 * 3, n_out=64)
        .override(3, layer_type="OUTPUT", n_in=64, n_out=10,
                  activation_function="softmax", loss_function="MCXENT")
        .input_preprocessor(0, "ff_to_conv")
        .input_preprocessor(2, "conv_to_ff")
        .pretrain(False).backward(True)
        .build()
    )


def conv_wide(lr: float = 0.01, num_iterations: int = 1, seed: int = 42
              ) -> MultiLayerConfiguration:
    """Wide conv stack: conv5x5 32→128ch on 32×32 input → pool2 →
    conv5x5 128→128 → pool2 → dense256 → softmax10. The im2col
    contractions are 32·25=800 and 128·25=3200 wide (both above the
    convolution route's gate, nn/layers/convolution.py), where LeNet's are
    25 and 150. Input is (batch, 32, 32, 32) NCHW; no ff_to_conv
    preprocessor (multi-channel input enters 4-D directly).
    """
    return (
        NeuralNetConfiguration.Builder()
        .lr(lr).momentum(0.9).use_ada_grad(False)
        .num_iterations(num_iterations).seed(seed)
        .weight_init("SIZE").activation_function("relu")
        .list(6)
        .override(0, layer_type="CONVOLUTION", n_in=32, n_out=128,
                  filter_size=(5, 5))
        .override(1, layer_type="SUBSAMPLING", stride=(2, 2))
        .override(2, layer_type="CONVOLUTION", n_in=128, n_out=128,
                  filter_size=(5, 5))
        .override(3, layer_type="SUBSAMPLING", stride=(2, 2))
        .override(4, layer_type="DENSE", n_in=128 * 5 * 5, n_out=256)
        .override(5, layer_type="OUTPUT", n_in=256, n_out=10,
                  activation_function="softmax", loss_function="MCXENT")
        .input_preprocessor(4, "conv_to_ff")
        .pretrain(False).backward(True)
        .build()
    )


def stacked_denoising_autoencoder(
    n_in: int = 784, hidden=(500, 250), n_out: int = 10,
    corruption_level: float = 0.3, lr: float = 0.1,
    num_iterations: int = 10, seed: int = 42,
) -> MultiLayerConfiguration:
    """SdA: AE layers pretrained greedily, then finetune + backprop
    (BASELINE config #3; ref workflow MultiLayerNetwork.java:150-191)."""
    n = len(hidden) + 1
    b = (
        NeuralNetConfiguration.Builder()
        .n_in(n_in).n_out(hidden[0]).activation_function("sigmoid")
        .lr(lr).corruption_level(corruption_level)
        .num_iterations(num_iterations).seed(seed)
        .loss_function("RECONSTRUCTION_CROSSENTROPY")
        .list(n)
    )
    prev = hidden[0]
    b.override(0, layer_type="AUTOENCODER")
    for i, h in enumerate(hidden[1:], start=1):
        b.override(i, layer_type="AUTOENCODER", n_in=prev, n_out=h)
        prev = h
    b.override(n - 1, layer_type="OUTPUT", n_in=prev, n_out=n_out,
               activation_function="softmax", loss_function="MCXENT")
    return b.pretrain(True).backward(True).build()


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
