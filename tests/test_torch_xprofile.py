"""The port's step profile (deeplearning4j_tpu_torch/telemetry/xprofile.py)
held against the JAX package's ``profile_compiled`` and against the
kernels' analytic costs (``ops/_kernels.py``).

FLOPs against JAX at vocab 64, d 32, 2 heads, 2 experts, d_ff 64, B=2,
T=32, dense attention: at one layer the port counts 6.365 MFLOP against
XLA's 6.769 (ratio 0.940: XLA also counts elementwise ops); at two layers
the port counts 11.944 (1.876 times its one-layer count), where XLA counts
6.858, about its one-layer count, because it counts the scanned layer
body once. Both are pinned in bands around these figures.

The collectives come from four gloo ranks started once for the module
(tests/_torch_profile_ranks.py, torch and the port only).
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
from torch.utils.flop_counter import FlopCounterMode

from _torch_lm_init import lm_params_np
from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.models import transformer_lm as JT
from deeplearning4j_tpu.telemetry import xprofile as jx
from deeplearning4j_tpu.telemetry.registry import MetricsRegistry as JReg
from deeplearning4j_tpu.telemetry.registry import flat_record as jflat
from deeplearning4j_tpu_torch._device import tree_leaves
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.models import transformer_lm as TT
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from deeplearning4j_tpu_torch.telemetry import xprofile as tx
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.telemetry.registry import flat_record

SCRIPT = Path(__file__).resolve().parent / "_torch_profile_ranks.py"
WORLD = 4
SPAWN_TIMEOUT_S = 240
V, D, H, E, FF, B, T = 64, 32, 2, 2, 64, 2, 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(layers, experts=E, seed=0):
    return jax.tree_util.tree_map(jnp.asarray, lm_params_np(
        seed, V, D, H, experts, FF, layers))


def _tokens(b=B, t=T, seed=2):
    toks = np.random.RandomState(seed).randint(0, V, (b, t + 1))
    return toks[:, :-1], toks[:, 1:]


def _port_profile(layers, impl="dense", t=T, **kw):
    params = lm_params_from_numpy(_np(_jax_params(layers)), "cpu")
    step = TT.make_single_device_train_step(H, attn_impl=impl, device="cpu",
                                            **kw)
    x, y = _tokens(t=t)
    return tx.profile_compiled(step, params, x, y, label="lm"), step, params


# ------------------------------------------------------------ FLOPs -------

def test_lm_flops_against_jax_profile_compiled():
    x, y = _tokens()
    ours, xla = {}, {}
    for layers in (1, 2):
        ours[layers] = _port_profile(layers)[0].flops
        jstep = JT.make_single_device_train_step(H, attn_impl="dense")
        xla[layers] = jx.profile_compiled(jstep, _jax_params(layers), x,
                                          y).flops
    assert 0.85 <= ours[1] / xla[1] <= 1.05, (ours, xla)
    assert 1.80 <= ours[2] / ours[1] <= 1.95, ours
    assert xla[2] / xla[1] <= 1.05, xla


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_alone_counts_its_analytic_cost(causal):
    """On the CPU the wrappers run their plain versions; the profile counts
    none of their ops, only the kernels' analytic costs: K3f for the
    forward, K3k and K3q added by the backward."""
    b, h, t, dh = 2, 2, 64, 16
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(b, h, t, dh, generator=gen)
                   for _ in range(4))
    fwd = _kernels.flash_attention_fwd_cost(b, h, t, dh, causal, 4)
    dkv = _kernels.flash_attention_bwd_dkv_cost(b, h, t, dh, causal, 4)
    dq = _kernels.flash_attention_bwd_dq_cost(b, h, t, dh, causal, 4)
    prof = tx.profile_compiled(fa.blockwise_attention, q, k, v, causal)
    assert prof.flops == fwd.flops
    assert prof.transcendentals == fwd.transcendentals
    assert prof.bytes_accessed == fwd.bytes
    assert prof.kernels == {"flash_attention_fwd": {
        "launches": 1, "flops": fwd.flops,
        "transcendentals": fwd.transcendentals, "bytes": fwd.bytes}}

    def fwd_bwd(q, k, v, do):
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o = fa.blockwise_attention(qg, kg, vg, causal)
        return torch.autograd.grad(o, (qg, kg, vg), do)

    prof = tx.profile_compiled(fwd_bwd, q, k, v, do)
    assert prof.flops == fwd.flops + dkv.flops + dq.flops
    assert prof.transcendentals == (fwd.transcendentals
                                    + dkv.transcendentals
                                    + dq.transcendentals)
    assert {n: e["launches"] for n, e in prof.kernels.items()} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dkv": 1,
        "flash_attention_bwd_dq": 1}
    # causal halving is stated once: causal = half the pairs
    full = _kernels.flash_attention_fwd_cost(b, h, t, dh, False, 4)
    half = _kernels.flash_attention_fwd_cost(b, h, t, dh, True, 4)
    assert half.flops * 2 == full.flops
    assert half.transcendentals * 2 == full.transcendentals


def test_lm_flash_route_counts_the_kernels_not_the_plain_version():
    """The flash route's count is the dense route's with the attention's
    six (T, T) products (2 forward, 4 backward, each 2·B·H·T²·Dh) replaced
    by the kernels' analytic costs: the plain version's blockwise
    recomputation, which a dispatch-level counter sees on the CPU, is not
    counted."""
    layers, t = 2, 64
    dense = _port_profile(layers, "dense", t=t)[0]
    flash, step, params = _port_profile(layers, "flash", t=t)
    dh = D // H
    attn = layers * 6 * 2.0 * B * H * t * t * dh
    kernels = sum(e["flops"] for e in flash.kernels.values())
    assert flash.flops == dense.flops - attn + kernels
    assert {n: e["launches"] for n, e in flash.kernels.items()} == {
        "flash_attention_fwd": layers, "flash_attention_bwd_dkv": layers,
        "flash_attention_bwd_dq": layers}
    with FlopCounterMode(display=False) as counter:
        step(params, *_tokens(t=t))
    assert counter.get_total_flops() > flash.flops
    assert dense.kernels == {}


# ------------------------------------------------------ profile fields ----

@pytest.mark.parametrize("donate", [False, True])
def test_profile_fields_and_donation_on_the_cpu(donate):
    prof, _, params = _port_profile(1, donate=donate)
    leaves = tree_leaves(params)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    assert prof.platform == "cpu" and prof.label == "lm"
    for name in ("temp_bytes", "peak_bytes", "generated_code_bytes",
                 "compile_seconds"):
        assert getattr(prof, name) is None, name
    assert prof.argument_bytes == nbytes  # the tokens are numpy arrays
    assert prof.output_bytes >= nbytes
    assert prof.donated_args == (len(leaves) if donate else 0)
    assert prof.alias_bytes == (nbytes if donate else 0)
    assert prof.collectives == {} and prof.collective_wire_bytes == 0.0
    x, y = _tokens()
    jprof = jx.profile_compiled(
        JT.make_single_device_train_step(H, attn_impl="dense"),
        _jax_params(1), x, y)
    assert set(jprof.to_dict()) <= set(prof.to_dict())


def test_profiled_step_returns_the_profiled_call_and_passes_through():
    params = lm_params_from_numpy(_np(_jax_params(1)), "cpu")
    x, y = _tokens()
    plain = TT.make_single_device_train_step(H, attn_impl="dense",
                                             device="cpu")
    step = TT.make_single_device_train_step(H, attn_impl="dense",
                                            profile=True, device="cpu")
    assert isinstance(step, tx.ProfiledStep)
    assert step.label == "lm_single_device" and step.step_profile is None
    want, got = plain(params, x, y), step(params, x, y)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(want), tree_leaves(got)))
    prof = step.step_profile
    assert prof.flops > 0
    assert tx.default_profile_store().get("lm_single_device") == \
        prof.to_dict()
    again = step(params, x, y)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(want), tree_leaves(again)))
    assert step.step_profile is prof and step.signature_fallbacks == 0
    x2, y2 = _tokens(t=T // 2)
    step(params, x2, y2)
    assert step.signature_fallbacks == 1 and step.step_profile is prof

    def fn(a):
        return a

    assert tx.maybe_profiled(fn, None, "x") is fn
    assert tx.maybe_profiled(fn, False, "x") is fn
    assert tx.maybe_profiled(fn, "mine", "x").label == "mine"
    with pytest.raises(ValueError, match="tune_context"):
        TT.make_single_device_train_step(H, tuned=True, device="cpu")


# --------------------------------------------- pure functions against JAX ----

def _sample_profile() -> dict:
    return {"label": "s", "platform": "gpu", "flops": 3.2e12,
            "transcendentals": 1e9, "bytes_accessed": 4.5e10,
            "argument_bytes": 10, "output_bytes": 12, "temp_bytes": 5,
            "alias_bytes": 10, "generated_code_bytes": None,
            "peak_bytes": 17, "compile_seconds": None, "donated_args": 3,
            "collectives": {"all-reduce": {"count": 1, "payload_bytes": 8,
                                           "wire_bytes": 12.0,
                                           "group_sizes": [4]}},
            "collective_ops": [{"kind": "all-reduce", "payload_bytes": 8,
                                "group_size": 4, "n_groups": 1,
                                "wire_bytes": 12.0}],
            "collective_wire_bytes": 1.5e9, "recorded_at": 1.0}


@pytest.mark.parametrize("seconds", [1e-3, 0.0123, 2.0])
def test_attribute_equals_jax_on_the_same_profile(seconds):
    d = _sample_profile()
    peaks = {"peak_flops": 989e12, "hbm_bytes_per_sec": 3.35e12,
             "ici_bytes_per_sec": 450e9}
    assert tx.attribute(tx.StepProfile.from_dict(d), seconds, **peaks) == \
        jx.attribute(jx.StepProfile.from_dict(d), seconds, **peaks)
    # the port's defaults are the card's (H100 80GB HBM3, 700 W)
    got = tx.attribute(tx.StepProfile.from_dict(d), seconds)
    assert got["model"] == peaks
    assert tx.attribute(tx.StepProfile.from_dict(
        {"label": "e", "platform": "cpu"}), seconds)["bound"] == "unknown"


def test_step_profile_round_trip_and_a_jax_dict_loads():
    prof = _port_profile(1)[0]
    d = prof.to_dict()
    assert tx.StepProfile.from_dict(d).to_dict() == d
    x, y = _tokens()
    jd = jx.profile_compiled(
        JT.make_single_device_train_step(H, attn_impl="dense"),
        _jax_params(1), x, y).to_dict()
    loaded = tx.StepProfile.from_dict(jd).to_dict()
    assert {k: loaded[k] for k in jd} == jd
    assert loaded["kernels"] == {}
    import json

    assert json.loads(prof.to_json()) == json.loads(json.dumps(d))


def test_store_records_and_mirrors_gauges_as_jax():
    d = _sample_profile()
    treg, jreg = MetricsRegistry(), JReg()
    tstore, jstore = tx.ProfileStore(treg), jx.ProfileStore(jreg)
    tstore.record(tx.StepProfile.from_dict(d))
    jstore.record(jx.StepProfile.from_dict(d))
    assert flat_record(treg, prefixes=("profile_",)) == \
        jflat(jreg, prefixes=("profile_",))
    assert "profile_compile_seconds{step=s}" not in flat_record(
        treg, prefixes=("profile_",))
    assert tstore.get("s") == tx.StepProfile.from_dict(d).to_dict()
    assert [p["label"] for p in tstore.snapshot()] == ["s"]


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "all-to-all",
                                  "collective-permute", "reduce-scatter"])
def test_wire_bytes_follow_jax_convention(kind):
    for group in (2, 4, 8):
        assert tx._wire_bytes(kind, 1000, group) == \
            jx._wire_bytes(kind, 1000, group)
    assert tx._wire_bytes(kind, 1000, 1) == 0.0


# --------------------------------------------------------- collectives ----

def _composed_input(mesh, capacity, **kw):
    toks = np.random.RandomState(5).randint(0, V, (4, 17))
    return dict(kind="profiled_composed", mesh=mesh, n_heads=H,
                capacity=capacity, tokens=toks[:, :-1], targets=toks[:, 1:],
                params=_np(_jax_params(1, experts=4, seed=3)), **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile_ranks")
    rng = np.random.RandomState(7)
    inputs = {
        "trainer": {"kind": "profiled_trainer", "mesh": (("data",), (4,))},
        "dp_ep": _composed_input((("data", "expert"), (2, 2)), 32,
                                 moe_impl="alltoall"),
        "dp_sp_ep": _composed_input((("data", "sp", "expert"), (1, 2, 2)),
                                    32, attn_impl="blockwise",
                                    moe_impl="alltoall"),
        "pipeline": {
            "kind": "profiled_pipeline", "mesh": (("data", "pipe"), (2, 2)),
            "batch_axis": "data",
            "stages": {"w": (rng.randn(2, 8, 8) / np.sqrt(8)).astype(
                np.float32), "b": (rng.randn(2, 8) * 0.1).astype(
                np.float32)},
            "x": rng.randn(3, 4, 8).astype(np.float32),
            "tgt": rng.randn(3, 4, 8).astype(np.float32)},
    }
    procs = spawn_ranks(root, inputs, WORLD, script=SCRIPT)
    return collect_ranks(root, procs, SPAWN_TIMEOUT_S)


def _results(ranks, name):
    out = [r[name] for r in ranks]
    for r in out:
        assert "error" not in r, r.get("error")
        assert r["equal"], "the profiled step changed an output"
    return out


def test_trainer_all_reduce_carries_the_grads_loss_and_weight_sums(ranks):
    for r in _results(ranks, "trainer"):
        prof = r["profile"]
        ar = prof["collectives"]["all-reduce"]
        assert ar["count"] == 1 and ar["group_sizes"] == [4]
        assert ar["payload_bytes"] == r["reduced_bytes"]
        assert prof["collective_wire_bytes"] == round(
            2 * 3 / 4 * r["reduced_bytes"], 1)
        assert prof["label"] == "dp_sync[4]" and prof["flops"] > 0
        (timing,) = r["timings"]
        assert timing["flops"] == prof["flops"]
        assert timing["comm_wait_ms"] == round(min(
            timing["device_ms"], prof["collective_wire_bytes"]
            / tx.DEFAULT_ICI_BYTES_PER_SEC * 1000.0), 4)


@pytest.mark.parametrize("name,kind", [("dp_ep", "all-to-all"),
                                       ("dp_sp_ep", "collective-permute"),
                                       ("pipeline", "collective-permute")])
def test_mesh_steps_record_their_collectives(ranks, name, kind):
    """The kinds JAX's HLO inventory shows for the same steps
    (tests/test_xprofile.py TestProfileSeamPaths), under the port's
    mapping: all_to_all is all-to-all, send_recv collective-permute."""
    for r in _results(ranks, name):
        prof = r["profile"]
        assert kind in prof["collectives"], prof["collectives"]
        assert prof["collective_wire_bytes"] > 0
        assert prof["collective_wire_bytes"] == round(sum(
            agg["wire_bytes"] for agg in prof["collectives"].values()), 1) \
            or len(prof["collective_ops"]) == 32


def test_world_size_one_carries_no_wire_bytes():
    """No process group: the mesh's collectives are the identity and the
    profile records none."""
    params = lm_params_from_numpy(_np(_jax_params(1)), "cpu")
    mesh = Mesh(("data",), (1,))
    step = TT.make_composed_train_step(mesh, H, B * T, profile=True,
                                       device="cpu")
    plain = TT.make_composed_train_step(mesh, H, B * T, device="cpu")
    x, y = _tokens()
    got, want = step(params, x, y), plain(params, x, y)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))
    assert step.label == "lm_composed[data]"
    assert step.step_profile.collective_wire_bytes == 0.0
    assert step.step_profile.collectives == {}


# ----------------------------------------------------- memory sampler ----

def test_watermark_sampler_cpu_degrades_gracefully():
    reg = MetricsRegistry()
    with tx.MemoryWatermarkSampler(registry=reg, interval_s=0.01) as s:
        pass
    assert s.watermarks() == {} and s.samples >= 2
    assert flat_record(reg)["profile_memory_samples_total"] >= 2


def test_watermark_math_on_synthetic_stats(monkeypatch):
    from deeplearning4j_tpu_torch.utils import profiling

    seq = iter([[{"device": "cuda:0", "bytes_in_use": 100,
                  "peak_bytes_in_use": 150}],
                [{"device": "cuda:0", "bytes_in_use": 300}],
                [{"device": "cuda:0", "bytes_in_use": 50,
                  "peak_bytes_in_use": 400}]])
    monkeypatch.setattr(profiling, "device_memory_stats", lambda: next(seq))
    reg = MetricsRegistry()
    s = tx.MemoryWatermarkSampler(registry=reg)
    for _ in range(3):
        s.sample_once()
    assert s.watermarks() == {"cuda:0": 300}
    flat = flat_record(reg, prefixes=("profile_memory",))
    assert flat["profile_memory_watermark_bytes"] == 300
    assert flat["profile_memory_bytes_in_use"] == 50
    assert flat["profile_memory_peak_bytes"] == 400
