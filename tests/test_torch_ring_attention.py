"""The port's sequence parallelism (deeplearning4j_tpu_torch/parallel/
ring_attention.py, ``forward_ring``, ``ops.flash_attention``'s
``blockwise_block_partials``) held against the JAX package's.

Four gloo ranks start ONCE for the module (tests/_torch_composed_ranks.py)
and run the ring, Ulysses and ``forward_ring`` on an ("sp",) mesh of 4 and
the ring on a ("data", "sp") mesh of 2×2, each rank on its sequence block;
JAX runs the same global inputs on 4-device meshes of the same shapes
meanwhile. The in-process ring (P shards in one process, the body the card
drives) and the block partials run here. Tolerances as JAX's own tests:
outputs 2e-5, grads 5e-5 (f32).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from _torch_lm_init import lm_params_np
from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.models import transformer_lm as JT
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn import params as jparams
from deeplearning4j_tpu.nn.layers import attention as jattn
from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu.parallel import ring_attention as jra
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.layers import attention as tattn
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.parallel import ring_attention as tra
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

SCRIPT = Path(__file__).resolve().parent / "_torch_composed_ranks.py"
WORLD = 4
ATOL, GRAD_ATOL = 2e-5, 5e-5
SPAWN_TIMEOUT_S = 240
SP4 = (("sp",), (4,))
DP_SP = (("data", "sp"), (2, 2))
RING_RUNS = {f"{impl}_{'causal' if c else 'full'}_{'pf' if pf else 'ra'}":
             {"causal": c, "attn_impl": impl, "prefetch": pf}
             for impl in ("dense", "blockwise") for c in (True, False)
             for pf in (True, False)}


def _qkv(b=2, h=4, t=64, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, h, t, d) * 0.5).astype(np.float32)
            for _ in range(3)]


def _jmesh(spec):
    names, sizes = spec
    return JMesh(np.array(jax.devices()[:WORLD]).reshape(sizes), names)


def _attn_conf():
    kw = dict(layer_type="ATTENTION", n_in=16, n_out=8, n_heads=4)
    jc = jconf.NeuralNetConfiguration(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jparams.init_layer_params(jax.random.PRNGKey(4), jc))
    return kw, jc, params


def _inputs():
    kw, _, params = _attn_conf()
    x = np.random.RandomState(9).randn(2, 32, 16).astype(np.float32)
    composed = {
        "kind": "composed", "mesh": (("data", "sp", "expert"), (1, 2, 2)),
        "n_heads": 2, "capacity": 32, "lr": 0.1, "moe_impl": "alltoall",
        "attn_impl": "blockwise",
        "params": lm_params_np(0, 32, 16, 2, 4, 32, 1),
        "batches": [tuple(np.random.RandomState(s).randint(0, 32, (4, 16))
                          .astype(np.int32) for s in (1, 2))] * 2}
    return {
        "ring_sp4": {"kind": "ring", "mesh": SP4, "axis": "sp",
                     "qkv": _qkv(), "runs": RING_RUNS},
        "ring_dp_sp": {"kind": "ring", "mesh": DP_SP, "axis": "sp",
                       "batch_axis": "data", "qkv": _qkv(seed=1),
                       "runs": {"blockwise": {"causal": True,
                                              "attn_impl": "blockwise"}}},
        "ulysses_blockwise": {"kind": "ulysses", "mesh": SP4, "axis": "sp",
                              "qkv": _qkv(seed=2),
                              "kw": {"causal": True,
                                     "attn_impl": "blockwise"}},
        "ulysses_dense": {"kind": "ulysses", "mesh": SP4, "axis": "sp",
                          "qkv": _qkv(seed=3), "kw": {"causal": False}},
        "forward_ring": {"kind": "forward_ring", "mesh": SP4, "axis": "sp",
                         "conf_kw": kw, "params": params, "x": x},
        "zz_prefetch_on": dict(composed, ring_prefetch=True),
        "zz_prefetch_off": dict(composed, ring_prefetch=False),
    }


def _jax_ring(inp, kw):
    mesh = _jmesh(inp["mesh"])
    q, k, v = (jnp.asarray(a) for a in inp["qkv"])

    def loss(q, k, v):
        o = jra.ring_attention(q, k, v, mesh, inp["axis"],
                               batch_axis=inp.get("batch_axis"), **kw)
        return jnp.sum(o * o), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in g]


def _jax_ulysses(inp):
    mesh = _jmesh(inp["mesh"])
    q, k, v = (jnp.asarray(a) for a in inp["qkv"])

    def loss(q, k, v):
        o = jra.ulysses_attention(q, k, v, mesh, inp["axis"], **inp["kw"])
        return jnp.sum(o * o), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in g]


def _jax_forward_ring(inp):
    mesh = _jmesh(inp["mesh"])
    _, jc, params = _attn_conf()
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def loss(p):
        y = jattn.forward_ring(jc, p, jnp.asarray(inp["x"]), mesh, "sp")
        return jnp.sum(y * y), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, g)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    inputs = _inputs()
    procs = spawn_ranks(root, inputs, WORLD, script=SCRIPT)
    try:
        ref = {}
        for name in ("ring_sp4", "ring_dp_sp"):
            inp = inputs[name]
            ref[name] = {run: _jax_ring(inp, {k: v for k, v in kw.items()
                                               if k != "prefetch"})
                         for run, kw in inp["runs"].items()
                         if kw.get("prefetch", True)}
        for name in ("ulysses_blockwise", "ulysses_dense"):
            ref[name] = _jax_ulysses(inputs[name])
        ref["forward_ring"] = _jax_forward_ring(inputs["forward_ring"])
    finally:
        results = collect_ranks(root, procs, SPAWN_TIMEOUT_S)
    return inputs, results, ref


def _rank(runs, name, rank):
    out = runs[1][rank][name]
    assert "error" not in out, out.get("error")
    return out


def _block(a, spec, rank, seq_dim=2, batch_axis=None):
    """Rank ``rank``'s block of the global ``a``."""
    names, sizes = spec
    shape = dict(zip(names, sizes))
    coords, rem = {}, rank
    for n in reversed(names):
        coords[n] = rem % shape[n]
        rem //= shape[n]
    k = a.shape[seq_dim] // shape["sp"]
    a = np.take(a, range(coords["sp"] * k, (coords["sp"] + 1) * k),
                axis=seq_dim)
    if batch_axis:
        r = a.shape[0] // shape[batch_axis]
        a = a[coords[batch_axis] * r:(coords[batch_axis] + 1) * r]
    return a


@pytest.mark.parametrize("run", sorted(r for r in RING_RUNS
                                       if r.endswith("_pf")))
def test_ring_matches_jax_outputs_and_grads(runs, run):
    """Every rank's output block and the grads of sum(o²) for its q/k/v
    blocks equal JAX's ring on the 4-device ("sp",) mesh."""
    o, grads = runs[2]["ring_sp4"][run]
    for rank in range(WORLD):
        got = _rank(runs, "ring_sp4", rank)[run]
        np.testing.assert_allclose(got["o"], _block(o, SP4, rank),
                                   atol=ATOL, rtol=ATOL)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(g, _block(w, SP4, rank),
                                       atol=GRAD_ATOL, rtol=GRAD_ATOL)


@pytest.mark.parametrize("run", sorted(r[:-3] for r in RING_RUNS
                                       if r.endswith("_pf")))
def test_ring_prefetch_bit_identical_to_rotate_after(runs, run):
    """prefetch=True (the rotation issued before the attend) and
    prefetch=False give bit-identical outputs and grads on every rank;
    each makes P-1 exchanges forward and P backward."""
    for rank in range(WORLD):
        out = _rank(runs, "ring_sp4", rank)
        pf, ra = out[run + "_pf"], out[run + "_ra"]
        np.testing.assert_array_equal(pf["o"], ra["o"])
        for a, b in zip(pf["grads"], ra["grads"]):
            np.testing.assert_array_equal(a, b)
        assert pf["collectives"]["send_recv"] == 3 + 4
        assert ra["collectives"] == pf["collectives"]


def test_ring_on_dp_sp_mesh_runs_a_ring_per_row(runs):
    o, grads = runs[2]["ring_dp_sp"]["blockwise"]
    for rank in range(WORLD):
        got = _rank(runs, "ring_dp_sp", rank)["blockwise"]
        np.testing.assert_allclose(
            got["o"], _block(o, DP_SP, rank, batch_axis="data"), atol=ATOL,
            rtol=ATOL)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(
                g, _block(w, DP_SP, rank, batch_axis="data"),
                atol=GRAD_ATOL, rtol=GRAD_ATOL)


@pytest.mark.parametrize("name", ["ulysses_blockwise", "ulysses_dense"])
def test_ulysses_matches_jax_and_rejects_indivisible_heads(runs, name):
    o, grads = runs[2][name]
    for rank in range(WORLD):
        got = _rank(runs, name, rank)
        np.testing.assert_allclose(got["o"], _block(o, SP4, rank),
                                   atol=ATOL, rtol=ATOL)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(g, _block(w, SP4, rank),
                                       atol=GRAD_ATOL, rtol=GRAD_ATOL)
        assert "divisible" in got["indivisible"]


def test_forward_ring_matches_jax(runs):
    y, grads = runs[2]["forward_ring"]
    for rank in range(WORLD):
        got = _rank(runs, "forward_ring", rank)
        np.testing.assert_allclose(got["y"], _block(y, SP4, rank, 1),
                                   atol=ATOL, rtol=ATOL)
        for k, w in grads.items():
            np.testing.assert_allclose(got["grads"][k], w, atol=GRAD_ATOL,
                                       rtol=GRAD_ATOL, err_msg=k)


def test_composed_ring_prefetch_bit_identical(runs):
    """The composed dp×sp×ep step with the prefetch ring and the
    rotate-after ring: losses and params bit-identical on every rank."""
    for rank in range(WORLD):
        on = _rank(runs, "zz_prefetch_on", rank)
        off = _rank(runs, "zz_prefetch_off", rank)
        assert on["losses"] == off["losses"]
        for a, b in zip(jax.tree_util.tree_leaves(on["params"]),
                        jax.tree_util.tree_leaves(off["params"])):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- in-process ----

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["dense", "blockwise"])
def test_ring_in_process_matches_jax_ring(causal, impl):
    """The ring's body over 4 shards in one process against JAX's ring on
    the 4-device mesh: outputs and grads of sum(o²)."""
    arrs = _qkv(seed=5)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    o = tra.ring_attention_in_process(q, k, v, 4, causal=causal,
                                      attn_impl=impl)
    got = torch.autograd.grad((o * o).sum(), (q, k, v))
    want_o, want_g = _jax_ring({"mesh": SP4, "axis": "sp", "qkv": arrs},
                               {"causal": causal, "attn_impl": impl})
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=ATOL,
                               rtol=ATOL)
    for g, w in zip(got, want_g):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL)


def test_ring_in_process_launches_each_kernel_once_a_pair(monkeypatch):
    """Under a causal mask the ring over P shards attends the P(P+1)/2
    pairs on or below the diagonal: one K3f, K3k and K3q each a pair
    (counted through the wrappers; the pairs above it launch nothing)."""
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        orig = getattr(tfa, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            _kernels.count_launch(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(seed=6))
    _kernels.reset_launches()
    o = tra.ring_attention_in_process(q, k, v, 4, causal=True,
                                      attn_impl="blockwise")
    (o * o).sum().backward()
    got = {n: _kernels.LAUNCHES.get(n, 0) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq")}
    assert got == dict.fromkeys(got, 10)


def test_long_sequence_in_process():
    """T=1024 over 8 shards of 128: the ring matches the dense reference
    on a slice (JAX's long-sequence check)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, h=2, t=1024, d=8,
                                                  seed=6))
    out = tra.ring_attention_in_process(q, k, v, 8, causal=True)
    ref = tra.reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out[0, 0, ::101].numpy(),
                               ref[0, 0, ::101].numpy(), atol=5e-5,
                               rtol=5e-5)


def test_ring_core_follows_global_override_and_env(monkeypatch):
    """set_attention_impl("blockwise") and DL4J_TPU_ATTN_IMPL reach the
    ring's per-pair core (a one-rank ring: one pair)."""
    seen = []
    orig = tfa.blockwise_block_partials

    def spy(*a, **kw):
        seen.append(tfa.get_attention_impl())
        return orig(*a, **kw)

    monkeypatch.setattr(tfa, "blockwise_block_partials", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed=10))
    mesh = Mesh(("sp",), (1,))
    ref = tra.reference_attention(q, k, v, causal=True)
    try:
        tfa.set_attention_impl("blockwise")
        out = tra.ring_attention(q, k, v, mesh, "sp", causal=True)
    finally:
        tfa.set_attention_impl(None)
    assert seen == ["blockwise"]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    monkeypatch.setenv(tfa.ATTN_IMPL_ENV, "blockwise")
    tra.ring_attention(q, k, v, mesh, "sp", causal=True)
    assert len(seen) == 2
    assert tra.sequence_sharding(mesh, "sp") == tuple(
        jra.sequence_sharding(_jmesh(SP4), "sp").spec)


# ------------------------------------------------------ block partials ----

@pytest.mark.parametrize("causal", [False, True])
def test_block_partials_match_jax_and_merge_unaligned(causal):
    """Q of 256 rows against K/V shards of 64 at their global offsets
    (Tq != Tk, offsets no multiple of Tq: the plain version's ground):
    each pair's partials equal JAX's where a row sees any key (a row
    masked everywhere has lse ≈ -1e30 in both and no weight), and the
    logsumexp merge equals the dense attention."""
    arrs = _qkv(b=2, h=2, t=256, d=32, seed=11)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    os_, lses = [], []
    for j in range(4):
        sl = slice(j * 64, (j + 1) * 64)
        o_j, lse_j = tfa.blockwise_block_partials(
            q, k[:, :, sl], v[:, :, sl], q_offset=0, k_offset=j * 64,
            causal=causal, block_q=64, block_k=64)
        jo, jl = jfa.blockwise_block_partials(
            jq, jk[:, :, sl], jv[:, :, sl], q_offset=0, k_offset=j * 64,
            causal=causal, block_q=64, block_k=64)
        assert o_j.dtype == lse_j.dtype == torch.float32
        seen = np.asarray(jl) > -1e29
        np.testing.assert_allclose(o_j.numpy()[seen], np.asarray(jo)[seen],
                                   atol=ATOL)
        np.testing.assert_allclose(lse_j.numpy()[seen], np.asarray(jl)[seen],
                                   atol=ATOL, rtol=ATOL)
        assert (lse_j.numpy()[~seen] < -1e29).all()
        os_.append(o_j)
        lses.append(lse_j)
    w = torch.softmax(torch.stack(lses), 0)[..., None]
    out = (torch.stack(os_) * w).sum(0)
    ref = jfa.dense_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_block_partials_kernel_modes_and_the_card_only_raise(monkeypatch):
    """On a tensor off the CPU (the meta device stands in for the card)
    every pair is one K3f launch at its diagonal shift: on the diagonal
    causal=1 shift 0, a block wholly before it causal=0, any other offset
    or Tq != Tk causal=1 at q_offset - k_offset; a block wholly after it
    is JAX's (0, -1e30) with no launch. No call raises any more: one that
    needs a gradient backs through one K3k and one K3q launch at the
    pair's shift and Tk, a wholly masked pair through none."""
    calls, bwd = [], []

    def fwd(q, k, v, causal=False, shift=0):
        calls.append((bool(causal), shift, q.shape[2], k.shape[2]))
        return torch.empty_like(q), q.new_empty(q.shape[:3])

    def dkv(q, k, v, lse, do, delta, causal=False, shift=0):
        assert delta.shape == lse.shape == q.shape[:3]
        bwd.append(("dkv", bool(causal), shift, q.shape[2], k.shape[2]))
        return torch.empty_like(k), torch.empty_like(v)

    def dq(q, k, v, lse, do, delta, causal=False, shift=0):
        bwd.append(("dq", bool(causal), shift, q.shape[2], k.shape[2]))
        return torch.empty_like(q)

    monkeypatch.setattr(tfa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkv", dkv)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq", dq)
    q, k, v = (torch.empty(1, 2, 64, 16, device="meta") for _ in range(3))
    tfa.blockwise_block_partials(q, k, v, 64, 64, causal=True)
    tfa.blockwise_block_partials(q, k, v, 128, 0, causal=True)
    tfa.blockwise_block_partials(q, k, v, 0, 96, causal=False)
    assert calls == [(True, 0, 64, 64), (False, 0, 64, 64),
                     (False, 0, 64, 64)]
    o, lse = tfa.blockwise_block_partials(q, k, v, 0, 64, causal=True)
    assert len(calls) == 3 and o.device.type == "meta"
    cpu = [torch.from_numpy(a[:, :, :64]) for a in _qkv(seed=12)]
    o, lse = tfa.blockwise_block_partials(*cpu, 0, 64, causal=True)
    assert (o == 0).all() and (lse == -1e30).all()
    tfa.blockwise_block_partials(q, k, v, 64, 32, causal=True)
    tfa.blockwise_block_partials(q, k[:, :, :32], v[:, :, :32], 0, 0)
    assert calls[3:] == [(True, 32, 64, 64), (False, 0, 64, 32)]
    assert bwd == []
    qg = q.clone().requires_grad_()
    for q_off, k_off, kk, want in (
            (64, 32, k, (True, 32, 64, 64)),
            (0, 0, k[:, :, :32], (True, 0, 64, 32)),
            (128, 0, k, (False, 0, 64, 64)),
            (10, 40, k[:, :, :48], (True, -30, 64, 48))):
        o, lse = tfa.blockwise_block_partials(qg, kk, v[:, :, :kk.shape[2]],
                                              q_off, k_off, causal=True)
        torch.autograd.grad((o, lse), qg, (torch.ones_like(o),
                                           torch.ones_like(lse)))
        assert calls[-1] == want
        assert bwd[-2:] == [("dkv", *want), ("dq", *want)]
    o, lse = tfa.blockwise_block_partials(qg, k, v, 0, 64, causal=True)
    assert not o.requires_grad and not lse.requires_grad
    with torch.no_grad():
        tfa.blockwise_block_partials(qg, k, v, 64, 32, causal=True)
    assert len(calls) == 10 and len(bwd) == 8


def test_blockwise_attention_is_the_kernel_route():
    arrs = _qkv(t=128, seed=13)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    got = tfa.blockwise_attention(q, k, v, True, 64, 64)
    want = jfa.blockwise_attention(*(jnp.asarray(a) for a in arrs), True,
                                   64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), tfa.attention_core(q, k, v, True, "blockwise").numpy())


def test_forward_ring_on_one_rank_is_forward():
    """With one rank on the axis the ring is the block itself; the layer's
    conf is the JAX package's."""
    kw, jc, params = _attn_conf()
    tc = tconf.NeuralNetConfiguration(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 16, 16)
                         .astype(np.float32))
    got = tattn.forward_ring(tc, tp, x, Mesh(("sp",), (1,)), "sp")
    np.testing.assert_allclose(got.numpy(),
                               tattn.forward(tc, tp, x).numpy(), atol=1e-6)
    want = jattn.forward(jc, jax.tree_util.tree_map(jnp.asarray, params),
                         jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ------------------------------------------- the block partials' backward --

PARTIAL_CASES = [(64, 64, 96, 57), (32, 96, 64, 0), (96, 32, 0, 40),
                 (96, 32, 60, 80)]


def _merged(partials, q, k, v, q_off, k_off, causal, w_o, w_l, seen):
    """Two K/V shards' partials merged by logsumexp weights, then a loss
    with cotangents on the merged output and the merged lse of the rows
    that see any key (zero on the rest)."""
    half = k.shape[2] // 2
    lib = jnp if isinstance(q, jnp.ndarray) else torch
    parts = [partials(q, k[:, :, s], v[:, :, s], q_off, k_off + s.start,
                      causal) for s in (slice(0, half),
                                        slice(half, k.shape[2]))]
    (o1, l1), (o2, l2) = parts
    big = lib.maximum(l1, l2)
    w1, w2 = lib.exp(l1 - big), lib.exp(l2 - big)
    lse = big + lib.log(w1 + w2)
    o = (o1 * (w1 / (w1 + w2))[..., None] + o2 * (w2 / (w1 + w2))[..., None])
    return (o * w_o * seen[:, None]).sum() + (lse * w_l * seen).sum()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk,q_off,k_off", PARTIAL_CASES)
def test_block_partials_grads_through_a_merge_match_jax(tq, tk, q_off, k_off,
                                                        causal):
    """``blockwise_block_partials`` is differentiable in q, k and v through
    both outputs, as JAX's lax version is: over two K/V shards at their
    global offsets (Tq != Tk, shifts that are no multiple of a shard),
    merged by logsumexp weights, the q, k, v grads of a loss on the merged
    output and lse equal ``jax.vjp`` of JAX's. Rows that see no key of
    either shard get zero cotangent (the port's (0, -1e30) and JAX's
    mean(v) both weigh 0 there)."""
    rng = np.random.RandomState(tq + 7 * tk + q_off)
    arrs = [(rng.randn(2, 2, t, 16) * 0.5).astype(np.float32)
            for t in (tq, tk, tk)]
    w_o = rng.randn(2, 2, tq, 16).astype(np.float32)
    w_l = rng.randn(2, 2, tq).astype(np.float32)
    seen = ((q_off + np.arange(tq) >= k_off) if causal
            else np.ones(tq, bool)).astype(np.float32)
    jloss = jax.value_and_grad(
        lambda a, b, c: _merged(jfa.blockwise_block_partials, a, b, c,
                                q_off, k_off, causal, jnp.asarray(w_o),
                                jnp.asarray(w_l), jnp.asarray(seen)),
        argnums=(0, 1, 2))
    want_loss, want = jloss(*(jnp.asarray(a) for a in arrs))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    before = dict(_kernels.LAUNCHES)
    loss = _merged(tfa.blockwise_block_partials, q, k, v, q_off, k_off,
                   causal, torch.from_numpy(w_o), torch.from_numpy(w_l),
                   torch.from_numpy(seen))
    got = torch.autograd.grad(loss, (q, k, v))
    assert _kernels.LAUNCHES == before
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL,
                               rtol=ATOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("tq,tk,shift", [(32, 48, -10), (48, 32, 5),
                                         (40, 40, -50)])
def test_plain_backward_at_a_shift_zeroes_masked_p(tq, tk, shift):
    """The plain backward at a shift selects P to 0 where the mask hides a
    key, as the kernels do: a row that sees no key (lse = -1e30) gets zero
    dq and adds nothing to dk, dv (exp(s - lse) would be 1 on every key),
    and the rest equal torch's autograd of the plain forward, with
    cotangents on o and on lse folded into delta - dlse."""
    rng = np.random.RandomState(tq + tk)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, t, 16).astype(np.float32))
               .double().requires_grad_() for t in (tq, tk, tk))
    do = torch.from_numpy(rng.randn(1, 2, tq, 16)).double()
    dlse = torch.from_numpy(rng.randn(1, 2, tq)).double()
    o, lse = tfa.flash_attention_reference(q, k, v, True, shift)
    blind = torch.arange(tq) + shift < 0
    p, _ = tfa._bwd_p_ds(q, k, v, lse, do, tfa.attention_delta(o, do), True,
                         shift)
    assert (p.masked_select(tfa._hidden(q, k, shift)) == 0).all()
    assert (p[:, :, blind] == 0).all()
    delta = tfa.attention_delta(o, do) - dlse
    dk, dv = tfa._bwd_dkv_plain(q, k, v, lse, do, delta, True, shift)
    dq = tfa._bwd_dq_plain(q, k, v, lse, do, delta, True, shift)
    want = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    assert (dq[:, :, blind] == 0).all()
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-10, msg=name)
