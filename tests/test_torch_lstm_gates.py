"""The port's LSTM cell (deeplearning4j_tpu_torch/ops/pallas_kernels
``lstm_gates``, kernel K2 on the card) held against the JAX package's
``lstm_gates`` on the CPU.

On the CPU the port's ``LSTMGates`` runs K2's plain version
(``lstm_gates_reference``: f32 math, one rounding to c_prev's dtype)
forward and the JAX backward's math (``_lstm_gates_bwd``) in torch. On the
JAX side, shapes that pass the TPU gate (h % 128, B % 8) run the Pallas
kernel in interpret mode; ragged shapes run ``_lstm_gates_ref`` under the
same custom VJP.

Error: max abs error over the reference's max abs value.
- f32: 1e-6 (both compute in f32; XLA's and torch's sigmoid and tanh
  differ in the last ulp: measured up to 2.3e-7);
- bf16: 3e-2 against ``jax.disable_jit()`` results. The port rounds each
  output once, as the TPU kernel does; the forward is held against the
  Pallas kernel in interpret mode (which takes any shape there) and the
  grads against ``_lstm_gates_bwd`` at the kernel's output, where the
  backward rounds per op in both packages.
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
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import pallas_kernels as tpk

# (B, H): the TPU gate's shape, and ragged ones
SHAPES = [(8, 128), (5, 16), (3, 10), (1, 1)]
TOL = {"f32": 1e-6, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(b, h, seed=0):
    """ifog (B, 4H), c_prev (B, H) and the cotangents of c_new and
    h_new."""
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


def _port(arrs, dtype):
    ifog, c, dc, dh = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    ifog.requires_grad_()
    c.requires_grad_()
    c_new, h_new = tpk.lstm_gates(ifog, c)
    grads = torch.autograd.grad((c_new, h_new), (ifog, c), (dc, dh))
    return (c_new, h_new), grads


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_grads_match_jax_f32(shape):
    arrs = _inputs(*shape)
    ifog, c, dc, dh = (jnp.asarray(a) for a in arrs)
    jout, vjp = jax.vjp(jpk.lstm_gates, ifog, c)
    jgrads = vjp((dc, dh))
    tout, tgrads = _port(arrs, "f32")
    for name, t, j in zip(("c_new", "h_new"), tout, jout):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, name
        assert _rel(_np(t), _np(j)) <= TOL["f32"], name
    for name, t, j in zip(("d_ifog", "dc_prev"), tgrads, jgrads):
        assert tuple(t.shape) == j.shape, name
        assert _rel(_np(t), _np(j)) <= TOL["f32"], name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_grads_match_eager_jax_bf16(shape):
    """bf16 against eager JAX: the forward against the public
    ``lstm_gates`` (the Pallas kernel at the gate's shape, ``_lstm_gates_ref``
    elsewhere) and against the Pallas kernel itself; the grads against
    ``_lstm_gates_bwd`` with the residuals ``_lstm_gates_fwd`` recomputes,
    at the kernel's output."""
    arrs = _inputs(*shape, seed=3)
    ifog, c, dc, dh = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    h = shape[1]
    with jax.disable_jit():
        jout = jpk.lstm_gates(ifog, c)
        kc, kh = jpk._lstm_gates_pallas(ifog, c)
        res = (jax.nn.sigmoid(ifog[:, :h]), jax.nn.sigmoid(ifog[:, h:2 * h]),
               jax.nn.sigmoid(ifog[:, 2 * h:3 * h]),
               jnp.tanh(ifog[:, 3 * h:]), c, jnp.tanh(kc))
        jgrads = jpk._lstm_gates_bwd(res, (dc, dh))
    tout, tgrads = _port(arrs, "bf16")
    for name, t, j, k in zip(("c_new", "h_new"), tout, jout, (kc, kh)):
        assert t.dtype == torch.bfloat16, name
        assert _rel(_np(t), _np(j)) <= TOL["bf16"], name
        assert _rel(_np(t), _np(k)) <= TOL["bf16"], name
    for name, t, j in zip(("d_ifog", "dc_prev"), tgrads, jgrads):
        assert t.dtype == torch.bfloat16, name
        assert _rel(_np(t), _np(j)) <= TOL["bf16"], name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_equals_the_pallas_kernel_bf16(shape):
    """Both compute in f32 and round once: the plain version and the TPU
    kernel (interpret mode) give the same bf16 outputs."""
    ifog, c, _, _ = _inputs(*shape, seed=5)
    with jax.disable_jit():
        kc, kh = jpk._lstm_gates_pallas(jnp.asarray(ifog, jnp.bfloat16),
                                        jnp.asarray(c, jnp.bfloat16))
    tc, th = tpk.lstm_gates_reference(torch.from_numpy(ifog).bfloat16(),
                                      torch.from_numpy(c).bfloat16())
    assert _rel(_np(tc), _np(kc)) <= TOL["bf16"]
    assert _rel(_np(th), _np(kh)) <= TOL["bf16"]


@pytest.mark.parametrize("ifog_dt,c_dt", [("f32", "f32"), ("bf16", "bf16"),
                                          ("bf16", "f32"), ("f32", "bf16")])
def test_reference_rounds_once_to_c_prev_dtype(ifog_dt, c_dt):
    """The plain version upcasts both inputs, computes in f32 and rounds
    once: it equals the f32 result rounded to c_prev's dtype, bit for bit,
    whatever the mix of input types."""
    ifog, c, _, _ = _inputs(6, 24, seed=9)
    ti = torch.from_numpy(ifog).to(TDT[ifog_dt])
    tc = torch.from_numpy(c).to(TDT[c_dt])
    got = tpk.lstm_gates_reference(ti, tc)
    want = tpk.lstm_gates_reference(ti.float(), tc.float())
    for g, w in zip(got, want):
        assert g.dtype == TDT[c_dt]
        assert torch.equal(g, w.to(TDT[c_dt]))


def test_gradcheck_float64():
    """The Function's hand-written backward against finite differences."""
    rng = np.random.RandomState(1)
    for b, h in ((3, 4), (2, 1)):
        ifog = torch.from_numpy(rng.randn(b, 4 * h)).requires_grad_()
        c = torch.from_numpy(rng.randn(b, h)).requires_grad_()
        assert torch.autograd.gradcheck(tpk.lstm_gates, (ifog, c))


def test_cpu_wrapper_uses_plain_version_and_counts_nothing():
    ifog, c, _, _ = _inputs(5, 16)
    ti, tc = torch.from_numpy(ifog), torch.from_numpy(c)
    before = _kernels.LAUNCHES["lstm_gates"]
    got = tpk.lstm_gates_fwd(ti, tc)
    want = tpk.lstm_gates_reference(ti, tc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    tpk.lstm_gates(ti, tc)
    assert _kernels.LAUNCHES["lstm_gates"] == before


def test_kernel_is_registered():
    assert "lstm_gates" in _kernels.LAUNCHES
    assert (_kernels.CSRC / "lstm_gates.cu").is_file()
    sig = _kernels._SIGNATURES["lstm_gates"]["dl4j_lstm_gates"]
    # ifog, c_prev, c_new, h_new, B, H, ifog_bf16, c_bf16, stream
    assert len(sig) == 9
    assert sig[4] is sig[5] is ctypes.c_longlong


@pytest.mark.parametrize("case,match", [
    ("ifog3d", "takes ifog"), ("width", "disagree"), ("rows", "disagree"),
    ("f64", "float32 or"), ("strided", "not contiguous"),
    ("cpu", "CUDA tensors")])
def test_kernel_input_checks(case, match):
    """What the launch wrapper refuses before it would launch K2: the
    checks run on the host, so they are held here on CPU tensors."""
    ifog, c = torch.ones(4, 20), torch.ones(4, 5)
    if case == "ifog3d":
        ifog = torch.ones(2, 4, 20)
    elif case == "width":
        ifog = torch.ones(4, 16)
    elif case == "rows":
        c = torch.ones(3, 5)
    elif case == "f64":
        c = c.double()
    elif case == "strided":
        ifog = torch.ones(20, 4).T
    with pytest.raises(ValueError, match=match):
        tpk._check_lstm_inputs(ifog, c)


def test_lstm_gates_switch_defaults_on_and_off_is_the_plain_version():
    """The default is on (the JAX default minus the TPU shape gate);
    ``set_lstm_gates(False)`` skips the wrapper that launches K2 and runs
    the plain version, which at bf16 agrees with JAX's
    ``set_lstm_gates(False)`` route (per-op rounding) within the bf16
    tolerance, forward and grads."""
    assert tpk.use_lstm_gates() is True
    ifog, c, dc, dh = _inputs(8, 128, seed=11)
    calls = []
    orig = tpk.lstm_gates_fwd
    tpk.lstm_gates_fwd = lambda *a: calls.append(1) or orig(*a)
    try:
        tpk.set_lstm_gates(False)
        jpk.set_lstm_gates(False)
        assert tpk.use_lstm_gates() is False
        (tc, th), tgrads = _port((ifog, c, dc, dh), "bf16")
        with jax.disable_jit():
            jout, vjp = jax.vjp(jpk.lstm_gates,
                                jnp.asarray(ifog, jnp.bfloat16),
                                jnp.asarray(c, jnp.bfloat16))
            jgrads = vjp((jnp.asarray(dc, jnp.bfloat16),
                          jnp.asarray(dh, jnp.bfloat16)))
    finally:
        tpk.lstm_gates_fwd = orig
        tpk.set_lstm_gates(None)
        jpk.set_lstm_gates(None)
    assert calls == [] and tpk.use_lstm_gates() is True
    want_c, want_h = tpk.lstm_gates_reference(
        torch.from_numpy(ifog).bfloat16(), torch.from_numpy(c).bfloat16())
    assert torch.equal(tc, want_c) and torch.equal(th, want_h)
    for t, j in zip((tc, th, *tgrads), (*jout, *jgrads)):
        assert _rel(_np(t), _np(j)) <= TOL["bf16"]
