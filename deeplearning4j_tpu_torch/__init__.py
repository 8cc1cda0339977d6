"""PyTorch/CUDA port of deeplearning4j_tpu, one slice at a time.

The JAX package ``deeplearning4j_tpu`` stays the reference; every module here
mirrors its counterpart's path and name there and is held against it by the
``tests/test_torch_*.py`` suite. This package imports ``torch`` and never
``jax`` nor anything of ``deeplearning4j_tpu``.

Slice 1 is the LM decode server: ``serve.engine.DecodeEngine`` over
``models.transformer_lm``, with prefill attention on the hand-written
Hopper flash-attention kernel in ``csrc/flash_attention_fwd.cu``. Slice 2
is single-device LM training: ``models.transformer_lm.
make_single_device_train_step`` with the ``optimize`` updaters and
guardrails, its attention differentiated by ``ops.flash_attention.
FlashAttention`` over that kernel and the backward pair in
``csrc/flash_attention_bwd_dkv.cu`` and ``csrc/flash_attention_bwd_dq.cu``.
Slice 3 is MultiLayerNetwork training and inference of the MNIST MLP:
``nn.multilayer.MultiLayerNetwork`` over ``nn.functional`` (confs, params,
dense and output layers, the updater), its dense layers' forward on the
hand-written fused-dense kernel in ``csrc/fused_dense.cu``
(``ops.pallas_kernels.fused_dense``). The CLI (``cli.driver``) drives
them as users do: ``predict`` serves the LM from a checkpoint of the JAX
package's format (``scaleout.ckpt``), and ``train``/``test``/``predict``
run a MultiLayerNetwork on CSV or svmLight records (``datasets.records``)
with ``eval.Evaluation``. The engine's fast path (``serve.prefix_cache``,
``serve.speculative``, chunked prefill) is traced by ``telemetry.trace``
and driven under open-loop load by ``serve.loadgen``. Slice 5 adds the
conv layers (``nn.layers.convolution``, ``subsampling``; LeNet's dense
layers on the fused-dense kernel), the solvers and listeners
(``optimize.solver``, ``optimize.listeners``) with net-state checkpoints
(``scaleout.ckpt.net_state``, ``CheckpointIterationListener``), and the
pretraining layers (``nn.layers.autoencoder``, ``rbm``,
``recursive_autoencoder``) behind ``MultiLayerNetwork.pretrain`` and
``finetune``. Slice 6 adds the text pipeline (``text``), the native host
library built from the repo's ``native/`` sources (``native``), and the
embedding models on the device (``models.word2vec``, ``models.glove``,
``models.paragraph_vectors``).
"""

from deeplearning4j_tpu_torch.nn.conf import (  # noqa: F401
    NeuralNetConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: F401
