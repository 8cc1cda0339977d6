"""The port's flash-attention backward (deeplearning4j_tpu_torch/ops/
flash_attention.py: ``flash_attention_bwd_reference``, the dK/dV and dQ
wrappers and the ``FlashAttention`` autograd Function) held against the JAX
package's ``blockwise_attention`` custom VJP, the lax twin of the library's
TPU backward kernels, which do not run on the CPU.

Inputs and upstream gradients come from numpy with a seed. Tolerances: f32
atol 1e-5 (the two sum in different orders); bf16 atol 3e-2 against eager
JAX (``jax.disable_jit()``: each op rounds to bf16 as torch's do; inputs
and outputs are bf16, ~2^-8 relative).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

ATOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(t, d, dtype, b=2, h=2, seed=0):
    """q, k, v, do for both packages, from one numpy draw."""
    rng = np.random.RandomState(seed + 7 * t + d)
    arrs = [rng.randn(b, h, t, d).astype(np.float32) for _ in range(4)]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _eager(dtype):
    return jax.disable_jit() if dtype == "bf16" else contextlib.nullcontext()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("t", [64, 128])
def test_bwd_reference_matches_blockwise_vjp(t, d, causal, dtype):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(t, d, dtype)
    blk = jfa.default_block_policy(t)
    with _eager(dtype):
        _, vjp = jax.vjp(
            lambda q, k, v: jfa.blockwise_attention(q, k, v, causal, blk,
                                                    blk), jq, jk, jv)
        want = vjp(jdo)
    o, lse = tfa.flash_attention_reference(tq, tk, tv, causal)
    got = tfa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TDT[dtype] and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL[dtype], rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["flash", "blockwise", "dense"])
def test_attention_core_grads_match_jax(impl, causal):
    """Gradients through every core reach q, k and v (the fault of the
    first slice: the flash output carried no graph, so q, k, v got none)
    and match JAX's; "flash" is held against JAX's "blockwise", the same
    function."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(64, 16, "f32", seed=3)
    jax_impl = "blockwise" if impl == "flash" else impl
    _, vjp = jax.vjp(lambda q, k, v: jfa.attention_core(
        q, k, v, causal=causal, impl=jax_impl), jq, jk, jv)
    want = vjp(jdo)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.attention_core(*leaves, causal=causal, impl=impl)
    got = torch.autograd.grad(out, leaves, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert float(g.abs().max()) > 0, name
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL["f32"], rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradcheck(causal):
    """Finite differences in float64 through the CPU path, at a ragged T."""
    gen = torch.Generator().manual_seed(1)
    qkv = [torch.randn(1, 2, 11, 8, generator=gen, dtype=torch.float64,
                       requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.FlashAttention.apply(q, k, v, causal), qkv)


def test_bwd_wrappers_compute_their_part_on_cpu_only():
    """On CPU tensors the two wrappers return the plain version's parts and
    launch nothing; the autograd Function runs the same wrappers, so a
    backward through it launches nothing here either."""
    _, (q, k, v, do) = _inputs(100, 16, "f32", seed=5)
    o, lse = tfa.flash_attention_reference(q, k, v, True)
    delta = tfa.attention_delta(o, do)
    before = dict(_kernels.LAUNCHES)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, True)
    dq = tfa.flash_attention_bwd_dq(q, k, v, lse, do, delta, True)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.FlashAttention.apply(*leaves, True)
    got = torch.autograd.grad(out, leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert _kernels.LAUNCHES == before


def test_serving_forward_under_inference_mode():
    """Serving calls the same core under inference_mode: no graph, the same
    output as the plain forward."""
    _, (q, k, v, _) = _inputs(64, 16, "bf16", seed=8)
    with torch.inference_mode():
        out = tfa.attention_core(q, k, v, causal=True, impl="blockwise")
    assert not out.requires_grad
    want, _ = tfa.flash_attention_reference(q, k, v, True)
    assert torch.equal(out, want)


def _meta(shape=(1, 2, 8, 16), dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bwd_args(**over):
    """q, k, v, lse, do, delta on the meta device (a stand-in for CUDA
    tensors: the wrappers check them before any launch)."""
    x = _meta()
    args = dict(q=x, k=x, v=x, lse=_meta((1, 2, 8)), do=x,
                delta=_meta((1, 2, 8)))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(q=_meta(dtype=torch.float16), k=_meta(dtype=torch.float16),
          v=_meta(dtype=torch.float16), do=_meta(dtype=torch.float16)),
     "float32 or bfloat16"),
    (dict(do=_meta((1, 2, 16, 8)).transpose(2, 3)), "not contiguous"),
    (dict(k=_meta((1, 2, 16, 8)).transpose(2, 3)), "not contiguous"),
    (dict(do=_meta(dtype=torch.bfloat16)), "do must share"),
    (dict(lse=_meta((1, 2, 8), torch.bfloat16)), "lse must be float32"),
    (dict(delta=_meta((1, 2, 9))), "delta must be float32"),
    (dict(lse=_meta((1, 8, 2)).transpose(1, 2)), "not contiguous"),
    (dict(), "CUDA tensors")])
@pytest.mark.parametrize("which", ["dkv", "dq"])
def test_bwd_kernel_input_checks(which, over, match):
    """What the kernels cannot take raises before any launch."""
    fn = (tfa.flash_attention_bwd_dkv if which == "dkv"
          else tfa.flash_attention_bwd_dq)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        fn(causal=True, **_bwd_args(**over))
    assert _kernels.LAUNCHES == before
