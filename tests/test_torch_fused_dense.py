"""The port's fused dense layer (deeplearning4j_tpu_torch/ops/pallas_kernels)
held against the JAX package's ``fused_dense`` on the CPU.

On the CPU the port's ``FusedDense`` runs the kernel's plain version
(``fused_dense_reference``) forward and the lax backward's math in torch.
The JAX side runs with ``set_fused_dense(True)`` (restored in ``finally``:
the tests' 8 fake host devices turn the JAX default off). Gate-passing
shapes such as (16,128)@(128,128) run the Pallas kernel in interpret mode;
ragged shapes such as (24,100)@(100,60) and (5,7)@(7,3) run ``_dense_ref``
under the same custom VJP.

Error: max abs error over the reference's max abs value.
- f32: 1e-5 (both sum in f32, in different orders);
- bf16: 3e-2 against ``jax.disable_jit()`` results. The port rounds its
  forward once to bf16, as the TPU kernel does; JAX's ragged-shape
  fallback rounds three times (product, bias add, activation), and the
  backward rounds per op in both, so the two sit a few bf16 steps
  (2^-8 relative each) apart (see the bf16 test for the grads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import pallas_kernels as tpk

ACTS = ["linear", "relu", "tanh", "sigmoid"]
SHAPES = [(16, 128, 128), (24, 100, 60), (5, 7, 3)]
TOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def jax_fused_on():
    jpk.set_fused_dense(True)
    try:
        yield
    finally:
        jpk.set_fused_dense(None)


def _inputs(m, k, n, seed=0):
    rng = np.random.RandomState(seed + 7 * m + k + n)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) / np.sqrt(k)).astype(np.float32),
            rng.randn(n).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_value_and_grads(arrs, act, dtype):
    x, w, b, g = (jnp.asarray(a, JDT[dtype]) for a in arrs)

    def f(x, w, b):
        return jpk.fused_dense(x, w, b, act)

    out, vjp = jax.vjp(f, x, w, b)
    return out, vjp(g)


def _port_value_and_grads(arrs, act, dtype):
    x, w, b, g = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    out = tpk.fused_dense(x, w, b, act)
    grads = torch.autograd.grad(out, (x, w, b), g)
    return out, grads


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("act", ACTS)
def test_forward_and_grads_match_jax_f32(jax_fused_on, act, shape):
    arrs = _inputs(*shape)
    jout, jgrads = _jax_value_and_grads(arrs, act, "f32")
    tout, tgrads = _port_value_and_grads(arrs, act, "f32")
    assert tout.dtype == torch.float32 and tuple(tout.shape) == jout.shape
    assert _rel(_np(tout), _np(jout)) <= TOL["f32"]
    for name, tg, jg in zip(("dx", "dW", "db"), tgrads, jgrads):
        assert tuple(tg.shape) == jg.shape, name
        assert _rel(_np(tg), _np(jg)) <= TOL["f32"], name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("act", ACTS)
def test_forward_and_grads_match_eager_jax_bf16(jax_fused_on, act, shape):
    """bf16 against eager JAX. The forward is held against the public
    ``fused_dense`` (three roundings on ragged shapes) and against the
    Pallas kernel itself in interpret mode, which takes any shape there and
    rounds once, as the port does. The grads are held against JAX's
    backward rule ``_fused_dense_bwd`` at the kernel's output: at a ragged
    shape the public function's output can sit one bf16 step away, and
    tanh's ``1 - out**2`` turns one step near saturation into a 20% change
    of that unit's derivative."""
    arrs = _inputs(*shape, seed=3)
    x, w, b, g = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    with jax.disable_jit():
        jout = jpk.fused_dense(x, w, b, act)
        kout = jpk._dense_pallas(x, w, b, act)
        jgrads = jpk._fused_dense_bwd(act, (x, w, kout), g)
    tout, tgrads = _port_value_and_grads(arrs, act, "bf16")
    assert tout.dtype == torch.bfloat16
    assert _rel(_np(tout), _np(jout)) <= TOL["bf16"]
    assert _rel(_np(tout), _np(kout)) <= TOL["bf16"]
    for name, tg, jg in zip(("dx", "dW", "db"), tgrads, jgrads):
        assert tg.dtype == torch.bfloat16, name
        assert _rel(_np(tg), _np(jg)) <= TOL["bf16"], name


@pytest.mark.parametrize("act", ACTS)
def test_reference_rounds_once_from_f32(act):
    """The plain version computes in f32 and rounds once to bf16: it
    equals the f32 result rounded, bit for bit."""
    x, w, b, _ = _inputs(24, 100, 60, seed=9)
    xb, wb, bb = (torch.from_numpy(a).bfloat16() for a in (x, w, b))
    got = tpk.fused_dense_reference(xb, wb, bb, act)
    want = tpk.fused_dense_reference(xb.float(), wb.float(), bb.float(),
                                     act).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_gradcheck_float64():
    """The Function's hand-written backward against finite differences."""
    rng = np.random.RandomState(1)
    for act in ("linear", "tanh", "sigmoid"):
        x, w, b = (torch.from_numpy(rng.randn(*s)).requires_grad_()
                   for s in ((5, 7), (7, 3), (3,)))
        assert torch.autograd.gradcheck(
            lambda x, w, b: tpk.fused_dense(x, w, b, act), (x, w, b))


def test_unknown_activation_raises_like_jax():
    x = torch.ones(2, 3)
    w = torch.ones(3, 4)
    b = torch.zeros(4)
    with pytest.raises(ValueError) as port_err:
        tpk.fused_dense(x, w, b, "softmax")
    with pytest.raises(ValueError) as jax_err:
        jpk.fused_dense(jnp.ones((2, 3)), jnp.ones((3, 4)), jnp.zeros(4),
                        "softmax")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="unsupported activation"):
        tpk.fused_dense_fwd(x, w, b, "cube")


def test_cpu_wrapper_uses_plain_version_and_counts_nothing():
    x, w, b, _ = _inputs(5, 7, 3)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    before = _kernels.LAUNCHES["fused_dense"]
    got = tpk.fused_dense_fwd(xt, wt, bt, "relu")
    assert torch.equal(got, tpk.fused_dense_reference(xt, wt, bt, "relu"))
    assert _kernels.LAUNCHES["fused_dense"] == before


def test_kernel_is_registered():
    assert "fused_dense" in _kernels.LAUNCHES
    assert (_kernels.CSRC / "fused_dense.cu").is_file()
    sig = _kernels._SIGNATURES["fused_dense"]["dl4j_fused_dense"]
    assert len(sig) == 10  # x, w, b, out, M, K, N, act, is_bf16, stream


@pytest.mark.parametrize("case,match", [
    ("x3d", "takes x"), ("k_mismatch", "disagree"), ("f64", "float32 or"),
    ("mixed", "share dtype"), ("strided", "not contiguous"),
    ("cpu", "CUDA tensors")])
def test_kernel_input_checks(case, match):
    """What the launch wrapper refuses before it would launch K1: the
    checks run on the host, so they are held here on CPU tensors."""
    x, w, b = torch.ones(4, 6), torch.ones(6, 5), torch.zeros(5)
    if case == "x3d":
        x = torch.ones(2, 4, 6)
    elif case == "k_mismatch":
        w = torch.ones(7, 5)
    elif case == "f64":
        x, w, b = x.double(), w.double(), b.double()
    elif case == "mixed":
        w = w.bfloat16()
    elif case == "strided":
        w = torch.ones(5, 6).T
    with pytest.raises(ValueError, match=match):
        tpk._check_kernel_inputs(x, w, b)


def test_fused_dense_switch_defaults_on():
    """One torch process drives one device, so the default is on (JAX's is
    ``device_count() == 1``); ``set_fused_dense`` overrides both ways."""
    assert tpk.use_fused_dense() is True
    try:
        tpk.set_fused_dense(False)
        assert tpk.use_fused_dense() is False
    finally:
        tpk.set_fused_dense(None)
    assert tpk.use_fused_dense() is True
