"""PyTorch/CUDA port of deeplearning4j_tpu, one slice at a time.

The JAX package ``deeplearning4j_tpu`` stays the reference; every module here
mirrors its counterpart's path and name there and is held against it by the
``tests/test_torch_*.py`` suite. This package imports ``torch`` and never
``jax`` nor anything of ``deeplearning4j_tpu``.

Slice 1 is the LM decode server: ``serve.engine.DecodeEngine`` over
``models.transformer_lm``, with prefill attention on the hand-written
Hopper flash-attention kernel in ``csrc/flash_attention_fwd.cu``.
"""
