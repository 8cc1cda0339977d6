"""The port's attention cores and selection chain held against the JAX
package (deeplearning4j_tpu/ops/flash_attention.py).

Inputs come from numpy with a seed and go through both packages. On the
CPU the port's "flash" and "blockwise" cores run the kernel's plain
version (``flash_attention_reference``); the JAX library TPU kernel cannot
run on the CPU, so "flash" is held against JAX's "blockwise", the same
function. Tolerances: f32 atol 1e-5 (the two sum in different orders), bf16
atol 3e-2 (inputs and outputs rounded to bf16, ~2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

ATOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qkv(t, dtype, b=2, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed + t)
    arrs = [rng.randn(b, h, t, d).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [8, 64, 1024])
@pytest.mark.parametrize("impl", ["dense", "blockwise", "flash"])
def test_attention_core_matches_jax(impl, t, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(t, dtype)
    jax_impl = "blockwise" if impl == "flash" else impl
    want = jfa.attention_core(jq, jk, jv, causal=causal, impl=jax_impl)
    got = tfa.attention_core(tq, tk, tv, causal=causal, impl=impl)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [8, 64, 1024])
def test_flash_reference_o_and_lse_match_jax(t, causal, dtype):
    """(o, lse) of the kernel's plain version against JAX's
    blockwise_attention (o) and blockwise_block_partials (lse, f32)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(t, dtype, seed=5)
    o, lse = tfa.flash_attention_reference(tq, tk, tv, causal)
    blk = jfa.default_block_policy(t)
    want_o = jfa.blockwise_attention(jq, jk, jv, causal, blk, blk)
    _, want_lse = jfa.blockwise_block_partials(jq, jk, jv, causal=causal)
    assert o.dtype == TDT[dtype] and lse.dtype == torch.float32
    assert tuple(lse.shape) == want_lse.shape
    np.testing.assert_allclose(_np(o), _np(want_o), atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(lse), _np(want_lse), atol=ATOL[dtype],
                               rtol=0)


def test_flash_wrapper_uses_plain_version_on_cpu_only():
    """On a CPU tensor the wrapper returns the plain version's result and
    launches nothing; on a non-contiguous view the core makes it
    contiguous first (the kernel path raises on views)."""
    from deeplearning4j_tpu_torch.ops import _kernels

    _, (q, k, v) = _qkv(100, "f32", seed=9)
    before = dict(_kernels.LAUNCHES)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert _kernels.LAUNCHES == before
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # non-contiguous
    assert not qt.is_contiguous()
    got = tfa.attention_core(qt, k, v, causal=True, impl="flash")
    torch.testing.assert_close(got, ro, atol=0, rtol=0)


def test_ragged_causal_rows_finite():
    """Right-padded prompt rows of a bucket are valid causal rows: no NaN,
    and a row's output depends only on the keys at or before it."""
    _, (q, k, v) = _qkv(100, "bf16", seed=11)
    o, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    o_cut, _ = tfa.flash_attention_reference(q[:, :, :37], k[:, :, :37],
                                             v[:, :, :37], causal=True)
    torch.testing.assert_close(o[:, :, :37], o_cut, atol=0, rtol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=12), "head dim"), (dict(d=136), "head dim"),
    (dict(), "CUDA tensors")])
def test_kernel_input_checks(bad, match):
    """What the kernel cannot take raises before any launch: shapes and
    dtypes first, then the device (meta tensors stand in here)."""
    d = bad.get("d", 16)
    x = torch.empty((1, 2, 8, d), dtype=bad.get("dtype", torch.float32),
                    device="meta")
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_fwd(x, x, x, causal=True)


# ------------------------------------------------------ selection chain ----

SETTINGS = [
    # (override, env value)
    (None, None), (None, "dense"), (None, "blockwise"), (None, "flash"),
    ("dense", None), ("flash", "dense"), ("blockwise", "flash"),
]
LENGTHS = [None, 8, 512, 1000, 1023, 1024, 1536, 2048, 3000, 4096]


@pytest.fixture
def clean_chain(monkeypatch):
    monkeypatch.delenv(jfa.ATTN_IMPL_ENV, raising=False)
    yield monkeypatch
    jfa.set_attention_impl(None)
    tfa.set_attention_impl(None)


@pytest.mark.parametrize("override,env", SETTINGS)
def test_selection_chain_matches_jax(clean_chain, override, env):
    assert tfa.ATTN_IMPL_ENV == jfa.ATTN_IMPL_ENV
    if env is not None:
        clean_chain.setenv(jfa.ATTN_IMPL_ENV, env)
    jfa.set_attention_impl(override)
    tfa.set_attention_impl(override)
    assert tfa.get_attention_impl() == jfa.get_attention_impl()
    for t in LENGTHS:
        assert tfa.resolve_attention_impl(t) == \
            jfa.resolve_attention_impl(t), t


@pytest.mark.parametrize("t", [1024, 2048])
def test_auto_gate_takes_dense_where_the_kernels_refuse(clean_chain, t):
    """Auto sends a head dim or dtype the kernels refuse to "dense" (the
    JAX package's lax "blockwise" runs them); what they take stays
    "blockwise". On meta tensors, auto runs at Dh=256, and a forced
    "blockwise" raises naming the limit before any launch."""
    for head_dim, dtype in ((256, torch.float32), (12, torch.float32),
                            (128, torch.float16), (64, torch.float16)):
        assert tfa.resolve_attention_impl(t, head_dim, dtype) == "dense"
    for head_dim in (8, 64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            assert tfa.resolve_attention_impl(t, head_dim, dtype) == \
                "blockwise"
    assert tfa.resolve_attention_impl(t) == jfa.resolve_attention_impl(t)
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm
    assert tlm.selected_attn_impl(t, head_dim=256) == "dense"
    assert tlm.selected_attn_impl(t, head_dim=128) == "blockwise"
    x = torch.empty((1, 2, t, 256), device="meta")
    out = tfa.attention_core(x, x, x, causal=True)
    assert out.shape == x.shape and out.device.type == "meta"
    with pytest.raises(ValueError, match="up to 128"):
        tfa.attention_core(x, x, x, causal=True, impl="blockwise")
    clean_chain.setenv(jfa.ATTN_IMPL_ENV, "flash")
    assert tfa.resolve_attention_impl(t, 256, torch.float16) == "flash"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        h = torch.empty((1, 2, t, 64), dtype=torch.float16, device="meta")
        tfa.attention_core(h, h, h, causal=True)


def test_selection_chain_rejects_what_jax_rejects(clean_chain):
    for mod in (jfa, tfa):
        with pytest.raises(ValueError):
            mod.set_attention_impl("pallas")
    clean_chain.setenv(jfa.ATTN_IMPL_ENV, "bogus")
    for mod in (jfa, tfa):
        with pytest.raises(ValueError):
            mod.get_attention_impl()
    _, (q, k, v) = _qkv(8, "f32")
    with pytest.raises(ValueError):
        tfa.attention_core(q, k, v, impl="pallas")


def test_default_block_policy_matches_jax():
    for t in (1, 8, 100, 512, 768, 1000, 1024, 1536, 2048, 2500):
        assert tfa.default_block_policy(t) == jfa.default_block_policy(t)
