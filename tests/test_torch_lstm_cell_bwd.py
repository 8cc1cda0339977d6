"""The LSTM cell's backward in the port (deeplearning4j_tpu_torch/ops/
pallas_kernels ``lstm_gates_bwd``, kernel K2b on the card) held against
the JAX package's backward of ``lstm_gates`` on the CPU.

The JAX package differentiates ``lstm_gates`` through a custom VJP whose
backward (``_lstm_gates_bwd``) is lax; no Pallas kernel carries it. On the
CPU the port's wrapper runs K2b's plain version, ``lstm_gates_bwd_reference``:
f32 math from upcast inputs, each output rounded once. Inputs come from a
numpy seed; c_new is JAX's forward output, so both backwards see the same
inputs.

Error: max abs error over the reference's max abs value.
- f32: 1e-6 (both compute in f32; XLA's and torch's sigmoid and tanh
  differ in the last ulp);
- bf16: 3e-2, against eager JAX (``jax.disable_jit()``: every op rounds to
  bf16) and against jitted JAX (XLA fuses the backward and keeps f32
  between its ops); the port rounds each output once.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import lstm as tlstm
from deeplearning4j_tpu_torch.nn.params import RECURRENT_WEIGHT_KEY
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import pallas_kernels as tpk

# (B, H): the TPU gate's shape (the Pallas forward in interpret mode), and
# ragged ones (the lax forward)
SHAPES = [(8, 128), (5, 16), (3, 10), (1, 1)]
TOL = {"f32": 1e-6, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_ids = {"ids": lambda s: "x".join(map(str, s))}


def _inputs(b, h, seed=0):
    """ifog (B, 4H), c_prev (B, H) and the grads of c_new and h_new."""
    rng = np.random.RandomState(seed + 31 * b + h)
    return ((2 * rng.randn(b, 4 * h)).astype(np.float32),
            rng.randn(b, h).astype(np.float32),
            rng.randn(b, h).astype(np.float32),
            rng.randn(b, h).astype(np.float32))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_bwd(arrs, dtype, zero_dc=False):
    """JAX's forward c_new and the VJP's (d_ifog, dc_prev)."""
    ifog, c, dc, dh = (jnp.asarray(a, JDT[dtype]) for a in arrs)
    if zero_dc:
        dc = jnp.zeros_like(dc)
    (c_new, _), vjp = jax.vjp(jpk.lstm_gates, ifog, c)
    return c_new, vjp((dc, dh))


def _port_bwd(arrs, c_new, dtype, zero_dc=False):
    ifog, c, dc, dh = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    c_new = torch.from_numpy(np.array(_np(c_new))).to(TDT[dtype])
    return tpk.lstm_gates_bwd(ifog, c, c_new, None if zero_dc else dc, dh)


@pytest.mark.parametrize("zero_dc", [False, True], ids=["dc", "dc_none"])
@pytest.mark.parametrize("shape", SHAPES, **_ids)
def test_bwd_matches_jax_vjp_f32(shape, zero_dc):
    """f32 against ``jax.vjp`` of ``lstm_gates``; a None dc_new (the last
    timestep's) against JAX's zero cotangent."""
    arrs = _inputs(*shape)
    c_new, jgrads = _jax_bwd(arrs, "f32", zero_dc)
    tgrads = _port_bwd(arrs, c_new, "f32", zero_dc)
    for name, t, j in zip(("d_ifog", "dc_prev"), tgrads, jgrads):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, name
        assert _rel(_np(t), _np(j)) <= TOL["f32"], name


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("shape", SHAPES, **_ids)
def test_bwd_matches_jax_vjp_bf16(shape, jit):
    """bf16 against eager JAX (per-op rounding) and against jitted JAX
    (XLA's fusion of ``_lstm_gates_bwd``, f32 between its ops)."""
    arrs = _inputs(*shape, seed=3)
    if jit:
        c_new, jgrads = jax.jit(lambda *a: _jax_bwd(a, "bf16"))(*arrs)
    else:
        with jax.disable_jit():
            c_new, jgrads = _jax_bwd(arrs, "bf16")
    tgrads = _port_bwd(arrs, c_new, "bf16")
    for name, t, j in zip(("d_ifog", "dc_prev"), tgrads, jgrads):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16, name
        assert _rel(_np(t), _np(j)) <= TOL["bf16"], name


@pytest.mark.parametrize("ifog_dt,c_dt", [("f32", "f32"), ("bf16", "bf16"),
                                          ("bf16", "f32"), ("f32", "bf16")])
def test_reference_rounds_once_to_each_output_dtype(ifog_dt, c_dt):
    """The plain version upcasts every input, computes in f32 and rounds
    once: it equals the f32 result rounded to ifog's and c_prev's dtypes,
    bit for bit, whatever the mix of input types."""
    ifog, c, dc, dh = (torch.from_numpy(a) for a in _inputs(6, 24, seed=9))
    ti, tc = ifog.to(TDT[ifog_dt]), c.to(TDT[c_dt])
    c_new, _ = tpk.lstm_gates_reference(ti, tc)
    tdc, tdh = dc.to(TDT[c_dt]), dh.to(TDT[c_dt])
    got = tpk.lstm_gates_bwd_reference(ti, tc, c_new, tdc, tdh)
    want = tpk.lstm_gates_bwd_reference(ti.float(), tc.float(),
                                        c_new.float(), tdc.float(),
                                        tdh.float())
    for g, w, dt in zip(got, want, (ifog_dt, c_dt)):
        assert g.dtype == TDT[dt]
        assert torch.equal(g, w.to(TDT[dt]))


def test_reference_reads_none_as_zero():
    ifog, c, dc, dh = (torch.from_numpy(a) for a in _inputs(4, 8, seed=4))
    c_new, _ = tpk.lstm_gates_reference(ifog, c)
    zeros = torch.zeros_like(dc)
    for args in ((None, dh), (dc, None)):
        full = [zeros if a is None else a for a in args]
        got = tpk.lstm_gates_bwd_reference(ifog, c, c_new, *args)
        want = tpk.lstm_gates_bwd_reference(ifog, c, c_new, *full)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("used", ["both", "c_new", "h_new"])
def test_gradcheck_float64_through_the_backward(used):
    """The Function's backward against finite differences, with both
    outputs used and with one (the other's grad reaches the backward as
    None and is read as zero)."""
    pick = {"both": lambda out: out, "c_new": lambda out: out[0],
            "h_new": lambda out: out[1]}[used]
    rng = np.random.RandomState(2)
    for b, h in ((3, 4), (2, 1)):
        ifog = torch.from_numpy(rng.randn(b, 4 * h)).requires_grad_()
        c = torch.from_numpy(rng.randn(b, h)).requires_grad_()
        assert torch.autograd.gradcheck(
            lambda i, cc: pick(tpk.lstm_gates(i, cc)), (ifog, c))


def test_cpu_wrapper_uses_plain_version_and_counts_nothing():
    ifog, c, dc, dh = (torch.from_numpy(a) for a in _inputs(5, 16))
    c_new, _ = tpk.lstm_gates_reference(ifog, c)
    before = dict(_kernels.LAUNCHES)
    got = tpk.lstm_gates_bwd(ifog, c, c_new, dc, dh)
    want = tpk.lstm_gates_bwd_reference(ifog, c, c_new, dc, dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ifog.requires_grad_()
    c.requires_grad_()
    torch.autograd.grad(tpk.lstm_gates(ifog, c), (ifog, c), (dc, dh))
    assert _kernels.LAUNCHES == before


def _record_bwd_calls(monkeypatch):
    calls = []
    orig = tpk.lstm_gates_bwd

    def recording(ifog, c_prev, c_new, dc_new, dh):
        calls.append((dc_new, dh))
        return orig(ifog, c_prev, c_new, dc_new, dh)

    monkeypatch.setattr(tpk, "lstm_gates_bwd", recording)
    return calls


def _lstm_layer(hidden=6, n_in=5, batch=3, steps=4):
    """An LSTM layer conf, its recurrent weights and an input, from a
    numpy seed."""
    conf = NeuralNetConfiguration(layer_type="LSTM", n_in=n_in,
                                  n_out=hidden)
    rng = np.random.RandomState(0)
    w = 0.3 * rng.randn(1 + n_in + hidden, 4 * hidden)
    params = {RECURRENT_WEIGHT_KEY: torch.from_numpy(w.astype(np.float32))}
    x = torch.from_numpy(rng.randn(batch, steps, n_in).astype(np.float32))
    return conf, params, x


def test_layer_backward_reads_grads_in_place(monkeypatch):
    """Through the LSTM layer's time loop each timestep's cell calls the
    wrapper once. The last timestep's dc_new arrives as None (no zero-fill)
    and its dh as a row view of the stacked (B, T, H) grad, row stride T·H
    (no copy); the other timesteps' grads are contiguous sums. The grads
    equal the plain cell's."""
    conf, params, x = _lstm_layer()
    steps, hidden = x.shape[1], conf.n_out
    calls = _record_bwd_calls(monkeypatch)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    out = tlstm.hidden_sequence(conf, leaves, x)
    g = torch.autograd.grad(out.square().sum(), list(leaves.values()))
    assert len(calls) == steps
    last_dc, last_dh = calls[0]
    assert last_dc is None
    assert last_dh.stride() == (steps * hidden, 1)
    assert not last_dh.is_contiguous()
    assert all(dc is not None and dc.is_contiguous() and dh.is_contiguous()
               for dc, dh in calls[1:])
    tpk.set_lstm_gates(False)
    try:
        plain = {k: v.detach().requires_grad_() for k, v in params.items()}
        out = tlstm.hidden_sequence(conf, plain, x)
        want = torch.autograd.grad(out.square().sum(), list(plain.values()))
    finally:
        tpk.set_lstm_gates(None)
    assert len(calls) == steps
    assert all(torch.equal(a, b) for a, b in zip(g, want))


def test_switch_off_sends_the_backward_through_the_plain_version(
        monkeypatch):
    """``set_lstm_gates(False)`` skips both wrappers: the backward runs
    ``lstm_gates_bwd_reference`` (the switch is read in the forward)."""
    calls = _record_bwd_calls(monkeypatch)
    ifog, c, dc, dh = (torch.from_numpy(a) for a in _inputs(4, 8, seed=6))
    ifog.requires_grad_()
    c.requires_grad_()
    tpk.set_lstm_gates(False)
    try:
        out = tpk.lstm_gates(ifog, c)
    finally:
        tpk.set_lstm_gates(None)
    got = torch.autograd.grad(out, (ifog, c), (dc, dh))
    assert calls == []
    want = tpk.lstm_gates_bwd_reference(ifog.detach(), c.detach(),
                                        out[0].detach(), dc, dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rows_contiguous_keeps_row_views_and_copies_the_rest():
    wide = torch.randn(3, 4, 5)
    view = wide[:, 2]
    assert tpk._rows_contiguous(view) is view
    assert tpk._rows_contiguous(None) is None
    strided = torch.randn(5, 3).T
    got = tpk._rows_contiguous(strided)
    assert got.is_contiguous() and torch.equal(got, strided)


def test_kernel_is_registered():
    assert "lstm_gates_bwd" in _kernels.LAUNCHES
    assert (_kernels.CSRC / "lstm_gates_bwd.cu").is_file()
    sig = _kernels._SIGNATURES["lstm_gates_bwd"]["dl4j_lstm_gates_bwd"]
    # ifog, c_prev, c_new, dc_new, dc_stride, dh, dh_stride, d_ifog,
    # dc_prev, B, H, ifog_bf16, c_bf16, stream
    assert len(sig) == 14
    for k in (0, 1, 2, 3, 5, 7, 8, 13):
        assert sig[k] is ctypes.c_void_p, k
    for k in (4, 6, 9, 10):
        assert sig[k] is ctypes.c_longlong, k
    assert sig[11] is sig[12] is ctypes.c_int
    empty = _kernels._SIGNATURES["lstm_gates"]["dl4j_lstm_gates_empty"]
    assert empty == [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


@pytest.mark.parametrize("case,match", [
    ("c_new_shape", "c_new is"), ("c_new_dtype", "c_new is"),
    ("c_new_strided", "c_new is not contiguous"), ("dh_dtype", "dh is"),
    ("dc_dtype", "dc_new is"),
    ("dh_shape", "dh is"), ("dc_shape", "dc_new is"),
    ("dh_cols", "rows are not contiguous"), ("ifog_width", "disagree"),
    ("f64", "float32 or"), ("cpu", "CUDA tensors")])
def test_kernel_input_checks(case, match):
    """What the launch wrapper refuses before it would launch K2b: the
    checks run on the host, so they are held here on CPU tensors: the
    device check comes last, so every other fault names itself first."""
    ifog, c, c_new = torch.ones(4, 20), torch.ones(4, 5), torch.ones(4, 5)
    dc, dh = torch.ones(4, 5), torch.ones(4, 5)
    if case == "c_new_shape":
        c_new = torch.ones(4, 6)
    elif case == "c_new_dtype":
        c_new = c_new.bfloat16()
    elif case == "c_new_strided":
        c_new = torch.ones(5, 4).T
    elif case == "dh_dtype":
        dh = dh.bfloat16()
    elif case == "dc_dtype":
        dc = dc.double()
    elif case == "dh_shape":
        dh = torch.ones(4, 4)
    elif case == "dc_shape":
        dc = torch.ones(5)
    elif case == "dh_cols":
        dh = torch.ones(5, 4).T
    elif case == "ifog_width":
        ifog = torch.ones(4, 16)
    elif case == "f64":
        ifog = ifog.double()
    with pytest.raises(ValueError, match=match):
        tpk._check_lstm_bwd_inputs(ifog, c, c_new, dc, dh)


def test_row_strides_for_the_kernel():
    """Row views of a wider grad are read in place at their row stride; a
    None grad passes stride 0 (the kernel reads it as zero)."""
    assert tpk._row_stride("dh", torch.ones(4, 3, 5)[:, 1], 4, 5) == 15
    assert tpk._row_stride("dh", torch.ones(4, 5), 4, 5) == 5
    assert tpk._row_stride("dc_new", None, 4, 5) == 0
    # one column: any inner stride reads the same elements
    assert tpk._row_stride("dh", torch.ones(4, 3)[:, 1:2], 4, 1) == 3
