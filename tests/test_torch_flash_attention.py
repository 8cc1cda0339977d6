"""The port's attention cores and selection chain held against the JAX
package (deeplearning4j_tpu/ops/flash_attention.py).

Inputs come from numpy with a seed and go through both packages. On the
CPU the port's "flash" and "blockwise" cores run the kernel's plain
version (``flash_attention_reference``); the JAX library TPU kernel cannot
run on the CPU, so "flash" is held against JAX's "blockwise", the same
function. Tolerances: f32 atol 1e-5 (the two sum in different orders), bf16
atol 3e-2 (inputs and outputs rounded to bf16, ~2^-8 relative).
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
    (dict(d=12), "head dim"), (dict(d=264), "head dim"),
    (dict(), "CUDA tensors"), (dict(d=136), "CUDA tensors")])
def test_kernel_input_checks(bad, match):
    """What the kernel cannot take raises before any launch: shapes and
    dtypes first, then the device (meta tensors stand in here). A head dim
    of 136 (the wide kernels') passes the shape checks; 264 is past
    them."""
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
    JAX package's lax "blockwise" runs them): above 256, or not f32/bf16;
    what they take, Dh 256 included, stays "blockwise" as JAX's chain
    says. On meta tensors, auto runs at Dh=264 and 512, and a forced
    "blockwise" raises naming the limit before any launch."""
    for head_dim, dtype in ((264, torch.float32), (512, torch.bfloat16),
                            (12, torch.float32), (128, torch.float16),
                            (64, torch.float16)):
        assert tfa.resolve_attention_impl(t, head_dim, dtype) == "dense"
    for head_dim in (8, 64, 128, 136, 256):
        for dtype in (torch.float32, torch.bfloat16):
            assert tfa.resolve_attention_impl(t, head_dim, dtype) == \
                "blockwise" == jfa.resolve_attention_impl(t)
    assert tfa.resolve_attention_impl(t) == jfa.resolve_attention_impl(t)
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm
    assert tlm.selected_attn_impl(t, head_dim=264) == "dense"
    assert tlm.selected_attn_impl(t, head_dim=256) == "blockwise"
    assert tlm.selected_attn_impl(t, head_dim=128) == "blockwise"
    for head_dim in (264, 512):
        x = torch.empty((1, 2, t, head_dim), device="meta")
        out = tfa.attention_core(x, x, x, causal=True)
        assert out.shape == x.shape and out.device.type == "meta"
        with pytest.raises(ValueError, match="up to 256"):
            tfa.attention_core(x, x, x, causal=True, impl="blockwise")
    clean_chain.setenv(jfa.ATTN_IMPL_ENV, "flash")
    assert tfa.resolve_attention_impl(t, 256, torch.float16) == "flash"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        h = torch.empty((1, 2, t, 64), dtype=torch.float16, device="meta")
        tfa.attention_core(h, h, h, causal=True)


@pytest.mark.parametrize("override,env", SETTINGS)
def test_selection_chain_at_head_dim_256_matches_jax(clean_chain, override,
                                                     env):
    """With the head dim and dtype given, the chain at Dh 256 (f32, bf16)
    is JAX's (which takes no head dim: its lax blockwise runs any)."""
    if env is not None:
        clean_chain.setenv(jfa.ATTN_IMPL_ENV, env)
    jfa.set_attention_impl(override)
    tfa.set_attention_impl(override)
    for t in LENGTHS:
        for dtype in (torch.float32, torch.bfloat16):
            assert tfa.resolve_attention_impl(t, 256, dtype) == \
                jfa.resolve_attention_impl(t), (t, dtype)


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


# ------------------------------------- pairs at any shapes and offsets ----

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk,q_off,k_off", [
    (64, 64, 96, 57), (32, 96, 64, 0), (96, 32, 0, 40), (96, 32, 60, 80)])
def test_block_partials_any_shape_and_offset_match_jax(tq, tk, q_off, k_off,
                                                       causal, dtype):
    """Tq != Tk and shifts that are no multiple of a shard, through the
    wrapper's one route (``flash_attention_fwd`` at the shift; its plain
    version here): rows that see a key equal JAX's (o and lse). A row that
    sees none is the kernel's (o = 0, lse = -1e30), where JAX's additive
    mask gives mean(v) at lse ≈ -1e30: both weigh 0 in a merge."""
    rng = np.random.RandomState(tq + 3 * tk + q_off)
    arrs = [rng.randn(2, 2, t, 16).astype(np.float32) for t in (tq, tk, tk)]
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in arrs)
    q, k, v = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    o, lse = tfa.blockwise_block_partials(q, k, v, q_off, k_off, causal)
    jo, jl = jfa.blockwise_block_partials(jq, jk, jv, q_off, k_off, causal,
                                          tq, tk)
    assert o.dtype == lse.dtype == torch.float32
    assert tuple(o.shape) == jo.shape and tuple(lse.shape) == jl.shape
    seen = np.ones(tq, bool)
    if causal:
        seen = q_off + np.arange(tq) >= k_off
    np.testing.assert_allclose(_np(o)[:, :, seen], _np(jo)[:, :, seen],
                               atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(lse)[:, :, seen], _np(jl)[:, :, seen],
                               atol=ATOL[dtype], rtol=ATOL[dtype])
    if seen.all():
        return
    assert (_np(o)[:, :, ~seen] == 0).all()
    assert (_np(lse)[:, :, ~seen] == -1e30).all()
    assert (_np(jl)[:, :, ~seen] < -1e29).all()
    mean_v = _np(jv).mean(2, keepdims=True)
    np.testing.assert_allclose(
        _np(jo)[:, :, ~seen],
        np.broadcast_to(mean_v, _np(jo)[:, :, ~seen].shape),
        atol=ATOL[dtype], rtol=0)


def test_fwd_cost_old_modes_equal_and_shifted_pairs_the_area():
    """K3f's cost at Tq == Tk and shift 0 is the old one (B·H·T²/2 pairs
    causal, B·H·T² not); at a shift it is the area under the shifted
    diagonal, within Tq/2 pairs of the exact count a head; the bytes read
    k and v at Tk."""
    from deeplearning4j_tpu_torch.ops import _kernels

    for causal in (True, False):
        c = _kernels.flash_attention_fwd_cost(4, 4, 2048, 128, causal, 2)
        t = 2048.0 * 2048 * 16
        assert c.transcendentals == (t / 2 if causal else t)
        assert c.flops == 4 * c.transcendentals * 128
        assert c.bytes == 4 * 16 * 2048 * 128 * 2 + 4.0 * 16 * 2048
    for tq, tk, shift in ((256, 768, 512), (768, 256, -300), (512, 512, 37),
                          (64, 64, -200), (64, 64, 500)):
        c = _kernels.flash_attention_fwd_cost(1, 1, tq, 8, True, 4, tk=tk,
                                              shift=shift)
        exact = np.clip(np.arange(tq) + shift + 1, 0, tk).sum()
        assert abs(c.transcendentals - exact) <= tq / 2
        assert c.bytes == 8 * 4 * (2 * tq + 2 * tk) + 4.0 * tq


# ------------------------------------------------- head dims up to 256 ----

def _eager(dtype):
    return jax.disable_jit() if dtype == "bf16" else contextlib.nullcontext()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 100])
@pytest.mark.parametrize("d", [136, 256])
@pytest.mark.parametrize("impl", ["blockwise", "flash"])
def test_attention_core_wide_head_dims_match_jax(impl, d, t, causal, dtype):
    """Head dims above 128 (the wide kernels' on the card; their plain
    versions here) through ``attention_core``: o and the q, k, v grads
    against ``jax.vjp`` of JAX's ``blockwise_attention`` (eager at bf16,
    where each op rounds as torch's do)."""
    rng = np.random.RandomState(d + t)
    arrs = [rng.randn(1, 2, t, d).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a, JDT[dtype]) for a in arrs)
    q, k, v = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_()
               for a in arrs[:3])
    do = torch.from_numpy(arrs[3]).to(TDT[dtype])
    blk = jfa.default_block_policy(t)
    with _eager(dtype):
        want, vjp = jax.vjp(lambda a, b, c: jfa.blockwise_attention(
            a, b, c, causal, blk, blk), jq, jk, jv)
        want_grads = vjp(jdo)
    got = tfa.attention_core(q, k, v, causal=causal, impl=impl)
    grads = torch.autograd.grad(got, (q, k, v), do)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got.detach()), _np(want),
                               atol=ATOL[dtype], rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert g.dtype == TDT[dtype], name
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL[dtype], rtol=0,
                                   err_msg=name)


def test_bwd_costs_old_modes_equal_and_shifted_pairs_the_area():
    """K3k's and K3q's costs at Tq == Tk and shift 0 are the old ones (four
    and three products over B·H·T²/2 pairs causal; 6 and 5 (T, Dh) tiles
    and lse, delta); at Tq != Tk and a shift the pairs are K3f's area,
    within Tq/2 of the exact count a head, and the bytes read q, do at Tq
    and k, v (and write dk, dv) at Tk."""
    from deeplearning4j_tpu_torch.ops import _kernels

    for causal in (True, False):
        b, h, t, dh, elt = 4, 4, 2048, 128, 4
        pairs = float(b * h * t * t) / (2 if causal else 1)
        tile = float(b * h * t * dh * elt)
        dkv = _kernels.flash_attention_bwd_dkv_cost(b, h, t, dh, causal, elt)
        dq = _kernels.flash_attention_bwd_dq_cost(b, h, t, dh, causal, elt)
        assert dkv.transcendentals == dq.transcendentals == pairs
        assert dkv.flops == 8 * pairs * dh and dq.flops == 6 * pairs * dh
        assert dkv.bytes == 6 * tile + 8.0 * b * h * t
        assert dq.bytes == 5 * tile + 8.0 * b * h * t
    for tq, tk, shift in ((256, 768, 512), (768, 256, -300), (512, 512, 37),
                          (64, 64, -200), (64, 64, 500)):
        fwd = _kernels.flash_attention_fwd_cost(1, 1, tq, 8, True, 4, tk=tk,
                                                shift=shift)
        dkv = _kernels.flash_attention_bwd_dkv_cost(1, 1, tq, 8, True, 4,
                                                    tk=tk, shift=shift)
        dq = _kernels.flash_attention_bwd_dq_cost(1, 1, tq, 8, True, 4,
                                                  tk=tk, shift=shift)
        exact = np.clip(np.arange(tq) + shift + 1, 0, tk).sum()
        assert dkv.transcendentals == dq.transcendentals == \
            fwd.transcendentals
        assert abs(dkv.transcendentals - exact) <= tq / 2
        assert dkv.flops == 8 * dkv.transcendentals * 8
        assert dq.flops == 6 * dq.transcendentals * 8
        assert dkv.bytes == 8 * 4 * (2 * tq + 4 * tk) + 8.0 * tq
        assert dq.bytes == 8 * 4 * (3 * tq + 2 * tk) + 8.0 * tq


def test_bwd_wrappers_price_the_pair_they_launch():
    """The backward wrappers report to a step profile the cost at the
    pair's Tk and shift (the CPU route prices as the card's), so a shifted
    backward is priced by its area."""
    from deeplearning4j_tpu_torch.ops import _kernels

    q = torch.zeros(1, 2, 32, 16)
    k = torch.zeros(1, 2, 96, 16)
    want = _kernels.flash_attention_bwd_dq_cost(1, 2, 32, 16, True, 4,
                                                tk=96, shift=64)
    assert tfa._bwd_cost(_kernels.flash_attention_bwd_dq_cost)(
        q, k, k, None, q, None, True, 64) == want
    assert tfa._bwd_cost(_kernels.flash_attention_bwd_dq_cost)(
        q, k, k, None, q, None, False, 64) == \
        _kernels.flash_attention_bwd_dq_cost(1, 2, 32, 16, False, 4, tk=96)
