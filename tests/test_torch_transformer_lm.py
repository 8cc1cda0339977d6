"""The port's transformer LM (deeplearning4j_tpu_torch/models/transformer_lm.py)
held against the JAX package's on the same parameters and inputs.

JAX parameters come from its own ``init_lm_params`` and are converted with
``interop.lm_params_from_numpy``. Sizes follow tests/test_serve.py. On the
CPU the port's "flash" core is the kernel's plain version, held against
JAX's "blockwise" (the library TPU kernel does not run on the CPU).
Tolerances: f32 atol 1e-4 (different summation orders through two layers
and the vocab projection); bf16 atol and rtol 3e-2 (every op rounds to
bf16, ~2^-8 relative, on logits of magnitude up to a few units).
JAX's ``lm_forward`` does not trace at bf16 (its scan carry widens to f32
through the f32 MoE combine), so it is compared at f32 only.
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

from deeplearning4j_tpu.models import transformer_lm as jlm
from deeplearning4j_tpu.nn.layers.attention import _layernorm as j_layernorm
from deeplearning4j_tpu.ops.flash_attention import attention_core as j_core
from deeplearning4j_tpu_torch.interop import (
    lm_params_from_numpy,
    opt_state_from_numpy,
)
from deeplearning4j_tpu_torch.models import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.layers.attention import (
    _layernorm as t_layernorm,
)
from deeplearning4j_tpu_torch.ops.flash_attention import (
    attention_core as t_core,
)

V, D, H, E, DFF, L = 61, 16, 2, 4, 32, 2
TOL = {"f32": dict(atol=1e-4, rtol=0), "bf16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def np_params():
    p = jlm.init_lm_params(jax.random.PRNGKey(0), V, D, H, E, DFF,
                           n_layers=L)
    return jax.tree_util.tree_map(np.asarray, p)


def _both(np_params, dtype):
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, JDT[dtype]),
                                np_params)
    tp = lm_params_from_numpy(np_params, "cpu", TDT[dtype])
    return jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _reference_mode(dtype):
    """The JAX reference runs op by op at bf16 (``jax.disable_jit``): each
    op then rounds to bf16, as each torch op does. Under jit, XLA's CPU
    fusion keeps f32 between some fused ops and moves results by a bf16
    step here and there (jit against eager JAX differ by as much as the
    tolerance), so the compiled program is no sharper an oracle."""
    return jax.disable_jit() if dtype == "bf16" else contextlib.nullcontext()


def _tokens(b, t, seed):
    return np.random.RandomState(seed).randint(0, V, (b, t)).astype(np.int32)


def _route_margin(tp, layer, x):
    """Smallest gap between the k-th and (k+1)-th router logit over the
    tokens of ``x``: a near-tie here is where the two packages may route a
    token differently, reported instead of loosening the tolerance."""
    logits = (x @ tp["blocks"]["router"][layer]).float()
    top = torch.sort(logits, -1, descending=True)[0]
    return float((top[:, 1] - top[:, 2]).min())


def _jcore(impl):
    return lambda q, k, v: j_core(q, k, v, causal=True, impl=impl)  # noqa: E731


def _tcore(impl):
    return lambda q, k, v: t_core(q, k, v, causal=True, impl=impl)  # noqa: E731


def test_layernorm_population_variance():
    """jnp.var is the population variance; torch's default is unbiased.
    The port matches JAX, and the unbiased form would not."""
    rng = np.random.RandomState(3)
    x, g, b = rng.randn(4, 16), rng.randn(16), rng.randn(16)
    x, g, b = (a.astype(np.float32) for a in (x, g, b))
    want = np.asarray(j_layernorm(jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(b)))
    tx, tg, tb = (torch.from_numpy(a) for a in (x, g, b))
    got = t_layernorm(tx, tg, tb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mu = tx.mean(-1, keepdim=True)
    unbiased = ((tx - mu) * torch.rsqrt(tx.var(-1, keepdim=True) + 1e-5)
                * tg + tb).numpy()
    assert np.abs(unbiased - want).max() > 1e-2


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_lm_forward_matches_jax_f32(np_params, impl):
    jp, tp = _both(np_params, "f32")
    toks = _tokens(2, 12, seed=1)
    jimpl = "blockwise" if impl == "flash" else impl
    jmoe = lambda r, e, x: jlm.dense_moe(r, e, x, 2)  # noqa: E731
    tmoe = lambda r, e, x: tlm.dense_moe(r, e, x, 2)  # noqa: E731
    want, want_in = jlm.lm_forward(jp, jnp.asarray(toks), H, _jcore(jimpl),
                                   jmoe)
    got, got_in = tlm.lm_forward(tp, torch.from_numpy(toks), H,
                                 _tcore(impl), tmoe)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["f32"])
    np.testing.assert_allclose(_np(got_in), _np(want_in), **TOL["f32"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", [None, "flash"])
def test_lm_prefill_matches_jax(np_params, impl, dtype):
    jp, tp = _both(np_params, dtype)
    toks = _tokens(1, 16, seed=2)
    jimpl = "blockwise" if impl == "flash" else impl
    with _reference_mode(dtype):
        want, wks, wvs = jlm.lm_prefill(jp, jnp.asarray(toks), H,
                                        attn_impl=jimpl)
    got, gks, gvs = tlm.lm_prefill(tp, torch.from_numpy(toks), H,
                                   attn_impl=impl)
    assert tuple(gks.shape) == wks.shape == (L, 1, H, 16, D // H)
    assert got.dtype == TDT[dtype] and gks.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(gks), _np(wks), **TOL[dtype])
    np.testing.assert_allclose(_np(gvs), _np(wvs), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_decode_step_matches_jax(np_params, dtype):
    """One decode iteration over 3 slots at positions 0, 5 and the last
    cache position, on a cache holding random stale values."""
    jp, tp = _both(np_params, dtype)
    s, t_max = 3, 16
    rng = np.random.RandomState(4)
    shape = (L, s, H, t_max, D // H)
    ck = rng.randn(*shape).astype(np.float32)
    cv = rng.randn(*shape).astype(np.float32)
    toks = rng.randint(0, V, (s,)).astype(np.int32)
    pos = np.array([0, 5, t_max - 1], np.int32)
    jcache = {"k": jnp.asarray(ck, JDT[dtype]), "v": jnp.asarray(cv, JDT[dtype])}
    tcache = {"k": torch.from_numpy(ck).to(TDT[dtype]),
              "v": torch.from_numpy(cv).to(TDT[dtype])}
    with _reference_mode(dtype):
        wcache, want = jlm.lm_decode_step(jp, jcache, jnp.asarray(toks),
                                          jnp.asarray(pos), H)
    gcache, got = tlm.lm_decode_step(tp, tcache, torch.from_numpy(toks),
                                     torch.from_numpy(pos), H)
    assert gcache["k"] is tcache["k"]  # written in place
    np.testing.assert_allclose(_np(gcache["k"]), _np(wcache["k"]),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(gcache["v"]), _np(wcache["v"]),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_cache_writes_never_clamp(np_params):
    """JAX's dynamic_update_slice clamps an out-of-range start onto live
    positions; the port's cache writes raise instead (the engine keeps
    every write inside max_len and checks it)."""
    tp = lm_params_from_numpy(np_params, "cpu")
    cache = tlm.init_kv_cache(L, 2, H, D // H, 8, device="cpu")
    with pytest.raises(IndexError):
        tlm.lm_decode_step(tp, cache, torch.tensor([1, 2]),
                           torch.tensor([3, 8]), H)
    prefill = tlm.make_prefill_step(H)
    with pytest.raises(ValueError, match="max_len"):
        prefill(tp, cache, torch.zeros((1, 16), dtype=torch.int64), 3, 0,
                torch.tensor(0.0), None)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_moe_matches_jax(np_params, dtype, top_k):
    jp, tp = _both(np_params, dtype)
    x = np.random.RandomState(6).randn(24, D).astype(np.float32)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    layer = 1
    jexp = jax.tree_util.tree_map(lambda a: a[layer], jp["blocks"]["experts"])
    texp = {k: v[layer] for k, v in tp["blocks"]["experts"].items()}
    with _reference_mode(dtype):
        want = jlm.dense_moe(jp["blocks"]["router"][layer], jexp, jx, top_k)
    got = tlm.dense_moe(tp["blocks"]["router"][layer], texp, tx, top_k)
    assert got.dtype == torch.float32  # f32 one-hot combine, as in JAX
    margin = _route_margin(tp, layer, tx)
    np.testing.assert_allclose(
        _np(got), _np(want), **TOL[dtype],
        err_msg=f"smallest 2nd/3rd router-logit margin {margin:.3g}")


def test_routing_ties_keep_first_index():
    """jax.lax.top_k keeps the lower index on ties; so does the port."""
    from deeplearning4j_tpu.parallel.moe import _routing as j_routing
    from deeplearning4j_tpu_torch.parallel.moe import _routing as t_routing

    logits = np.array([[1.0, 2.0, 2.0, 0.5], [3.0, 3.0, 3.0, 3.0],
                       [0.0, -1.0, 0.0, 0.0]], np.float32)
    for k in (1, 2, 3):
        jidx, jg = j_routing(jnp.asarray(logits), k)
        tidx, tg = t_routing(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)


def test_init_lm_params_layout_matches_jax(np_params):
    gen = torch.Generator().manual_seed(0)
    tp = tlm.init_lm_params(gen, V, D, H, E, DFF, n_layers=L, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: a.shape, np_params)
    tshapes = {"embed": tuple(tp["embed"].shape),
               "dec_w": tuple(tp["dec_w"].shape),
               "dec_b": tuple(tp["dec_b"].shape),
               "blocks": {k: (tuple(v.shape) if k != "experts" else
                              {ek: tuple(ev.shape) for ek, ev in v.items()})
                          for k, v in tp["blocks"].items()}}
    assert tshapes == jshapes
    assert tlm.lm_dims(tp) == jlm.lm_dims(np_params)
    assert tlm.lm_n_layers(tp) == L
    assert tlm.lm_checkpoint_meta(tp, H) == jlm.lm_checkpoint_meta(
        np_params, H)
    # same seed, same tree; scales as in JAX (embed * 0.1)
    tp2 = tlm.init_lm_params(torch.Generator().manual_seed(0), V, D, H, E,
                             DFF, n_layers=L, device="cpu")
    assert torch.equal(tp["blocks"]["wq"], tp2["blocks"]["wq"])
    assert 0.05 < float(tp["embed"].std()) < 0.15
    with pytest.raises(ValueError):
        tlm.init_lm_params(gen, V, D, 3, E, DFF, device="cpu")


def test_entry_points_raise_without_cuda(np_params):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_lm_params(torch.Generator(), V, D, H, E, DFF)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy(np_params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_kv_cache(L, 2, H, D // H, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.make_single_device_train_step(H)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.make_single_device_train_step(H, optimizer="adam")
    tp = lm_params_from_numpy(np_params, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_lm_opt_state("adam", tp)
    state = {"m": np_params, "v": np_params, "count": np.int32(0)}
    with pytest.raises(RuntimeError, match="CUDA"):
        opt_state_from_numpy(state)


def test_interop_rejects_foreign_tree(np_params):
    bad = dict(np_params, extra=np.zeros(1))
    with pytest.raises(ValueError, match="exactly"):
        lm_params_from_numpy(bad, "cpu")
    jb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                np_params)
    tb = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jb), "cpu")
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb["embed"].float().numpy(),
        np.asarray(jb["embed"].astype(jnp.float32)))


def test_sample_tokens_greedy_per_slot():
    """Greedy rows pick the argmax; sampling rows draw in range from the
    engine's generator (distribution-only: JAX's draws cannot match)."""
    rng = np.random.RandomState(8)
    logits = torch.from_numpy(rng.randn(6, V).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7, -1.0, 2.0])
    gen = torch.Generator().manual_seed(0)
    out = tlm.sample_tokens(logits, gen, temps)
    assert out.shape == (6,) and out.dtype == torch.int32
    assert ((out >= 0) & (out < V)).all()
    greedy = logits.argmax(-1)
    for i in (0, 2, 4):
        assert int(out[i]) == int(greedy[i])
    one = tlm.sample_tokens(logits[0], gen, torch.tensor(0.0))
    assert one.shape == () and int(one) == int(greedy[0])


@pytest.mark.parametrize("d_model", [256, 512])
def test_lm_step_at_head_dim_256_matches_jax(d_model):
    """One SGD step of the LM with heads of 256 (1 layer, vocab 64, T 64;
    one head at d_model 256, two at 512) through the "blockwise" core,
    which the wide kernels carry on the card (their plain versions here),
    against JAX's step (its lax blockwise_attention) at the f32
    tolerance: the loss and every leaf of the updated params."""
    from _torch_lm_init import lm_params_np
    from deeplearning4j_tpu_torch.interop import tree_to_numpy

    heads = d_model // 256
    np_p = lm_params_np(0, 64, d_model, heads, 2, 64, 1)
    toks = np.random.RandomState(3).randint(0, 64, (2, 65)).astype(np.int32)
    tok, tgt = toks[:, :-1], toks[:, 1:]
    jstep = jlm.make_single_device_train_step(heads, attn_impl="blockwise")
    tstep = tlm.make_single_device_train_step(heads, attn_impl="blockwise",
                                              device="cpu")
    jp, jloss = jstep(jax.tree_util.tree_map(jnp.asarray, np_p),
                      jnp.asarray(tok), jnp.asarray(tgt))
    tp, tloss = tstep(lm_params_from_numpy(np_p, "cpu"), tok, tgt)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL["f32"])
    got = jax.tree_util.tree_leaves(tree_to_numpy(tp))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL["f32"])
