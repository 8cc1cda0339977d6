"""The 3xTF32 split that K3f (csrc/flash_attention_fwd.cu), K1
(csrc/fused_dense.cu) and the backward pair K3k/K3q
(csrc/flash_attention_bwd_dkv.cu, csrc/flash_attention_bwd_dq.cu) use for
f32 inputs, emulated on the CPU and held to the card's unchanged f32
tolerances against float64.

The emulation follows the kernels: ``cvt.rna.tf32.f32`` rounds to 10
mantissa bits, to nearest with ties away from zero (13 low bits cleared);
x = hi + lo with hi = tf32(x), lo = tf32(x - hi); each product is
a_hi*b_hi + a_hi*b_lo + a_lo*b_hi (products of two TF32 values are exact
in f32), summed in f32 over K chunks of 8 (one m16n8k8 step) and added to
an f32 accumulator. The tolerances are chip_smoke.py's: ``DENSE_TOL`` f32
(1e-5 of the reference's max) for the MNIST MLP's products, ``TOL`` f32
(2e-5 on o and on lse) for causal attention, ``BWD_TOL`` f32 (1e-4 of the
reference's max) for its dq, dk and dv. A single TF32 pass (a_hi*b_hi
alone) misses them: the tests can tell the two apart.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

import chip_smoke

DENSE_TOL = chip_smoke.DENSE_TOL["float32"]  # 1e-5 of the reference's max
ATTN_TOL = chip_smoke.TOL["float32"]["o"]    # 2e-5, on o and on lse
assert chip_smoke.TOL["float32"]["lse"] == ATTN_TOL


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an f32 tensor: round the magnitude to nearest,
    ties away from zero, then clear the 13 low mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3,
            chunk: int = 8) -> torch.Tensor:
    """a @ b (f32) as the kernels compute it: per K chunk of 8 the TF32
    products summed in f32, then added to an f32 accumulator. ``passes=1``
    is a single TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for c in range(0, a.shape[1], chunk):
        s = slice(c, c + chunk)
        part = ah[:, s] @ bh[s]
        if passes == 3:
            part = part + (ah[:, s] @ bl[s] + al[:, s] @ bh[s])
        acc = acc + part
    return acc


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    cases = [(one + 2.0 ** -11, one + 2.0 ** -10),       # tie: away
             (-(one + 2.0 ** -11), -(one + 2.0 ** -10)),
             (one + 2.0 ** -12, one),                     # below half
             (one + 3 * 2.0 ** -12, one + 2.0 ** -10),    # above half
             (one + 2.0 ** -10, one + 2.0 ** -10),        # representable
             (0.0, 0.0)]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    r = tf32(torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


def test_split_is_exact_to_22_bits():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32))
    hi, lo = split(x)
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.abs().double()
    assert float(err.max()) < 2.0 ** -21


def _dense(m, k, n, seed):
    """chip_smoke's _dense_inputs: x ~ U[0, 1), W ~ N(0, 1/k), b ~ 0.1 N."""
    rng = np.random.default_rng(seed)
    x = rng.random((m, k), dtype=np.float32)
    w = (rng.standard_normal((k, n)) / k ** 0.5).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return (torch.from_numpy(a) for a in (x, w, b))


@pytest.mark.parametrize("m,k,n", [(512, 784, 500), (512, 500, 300)])
@pytest.mark.parametrize("passes,meets", [(3, True), (1, False)])
def test_mlp_products_meet_dense_tol(m, k, n, passes, meets):
    """The MNIST MLP's layers, relu(x @ W + b) with the bias and relu in
    f32 after the product, against float64."""
    x, w, b = _dense(m, k, n, seed=m + k + n)
    got = torch.relu(mm_tf32(x, w, passes) + b)
    want = torch.relu(x.double() @ w.double() + b.double())
    assert (_rel(got, want) <= DENSE_TOL) is meets, _rel(got, want)


def _attention(q, k, v, passes):
    """K3f's f32 math for one (B*H) slice: 3xTF32 scores, f32 softmax with
    the -1e30 causal mask, 3xTF32 P V, o / max(l, 1e-30), lse."""
    t, d = q.shape
    s = mm_tf32(q, k.T.contiguous(), passes) * (1.0 / d ** 0.5)
    mask = torch.arange(t)[:, None] < torch.arange(t)[None, :]
    s = s.masked_fill(mask, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[:, None])
    l = p.sum(-1).clamp_min(1e-30)
    o = mm_tf32(p, v, passes) / l[:, None]
    return o, m + torch.log(l)


@pytest.mark.parametrize("passes,meets", [(3, True), (1, False)])
def test_causal_attention_meets_tol(passes, meets):
    """Causal attention at B=1 H=2 T=256 Dh=128, inputs ~ N(0, 1) as
    chip_smoke's _qkv makes them: o and lse within 2e-5 of float64."""
    rng = np.random.default_rng(7)
    errs = []
    for _ in range(2):  # heads
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (256, 128)).astype(np.float32)) for _ in range(3))
        o, lse = _attention(q, k, v, passes)
        qd, kd, vd = q.double(), k.double(), v.double()
        s = (qd @ kd.T) / 128 ** 0.5
        mask = torch.arange(256)[:, None] < torch.arange(256)[None, :]
        s = s.masked_fill(mask, -1e30)
        want_lse = torch.logsumexp(s, -1)
        want_o = torch.softmax(s, -1) @ vd
        errs += [float((o.double() - want_o).abs().max()),
                 float((lse.double() - want_lse).abs().max())]
    assert (max(errs) <= ATTN_TOL) is meets, errs


BWD_TOL = chip_smoke.BWD_TOL["float32"]  # 1e-4 of the reference's max


def mm_sliced(a: torch.Tensor, b: torch.Tensor, passes: int = 3,
              width: int = 32) -> torch.Tensor:
    """a @ b (f32) as K3k and K3q compute it: each slice of ``width`` along
    the summed dimension (32 of Dh for the scores, one 32-row half of a
    walked tile for dV, dK and dQ) is summed in fresh accumulators, the
    TF32 products of the big term and of the correction terms apart, and
    added to an f32 accumulator. ``passes=1`` is a single TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for c in range(0, a.shape[1], width):
        s = slice(c, c + width)
        part = ah[:, s] @ bh[s]
        if passes == 3:
            part = part + (ah[:, s] @ bl[s] + al[:, s] @ bh[s])
        acc = acc + part
    return acc


def _attention_bwd(q, k, v, do, passes):
    """K3k's and K3q's f32 math for one (B*H) slice, from K3f's emulated
    o and lse: P = exp(s - lse) selected to 0 above the diagonal, dS =
    P (do v^T - delta) with delta = rowsum(do o), dv = P^T do, dk = dS^T q
    scale, dq = dS k scale."""
    t, d = q.shape
    scale = 1.0 / d ** 0.5
    o, lse = _attention(q, k, v, passes)
    delta = (do * o).sum(-1)
    mask = torch.arange(t)[:, None] < torch.arange(t)[None, :]
    s = mm_sliced(q, k.T.contiguous(), passes) * scale
    p = torch.exp(s - lse[:, None]).masked_fill(mask, 0.0)
    ds = p * (mm_sliced(do, v.T.contiguous(), passes) - delta[:, None])
    dv = mm_sliced(p.T.contiguous(), do, passes)
    dk = mm_sliced(ds.T.contiguous(), q, passes) * scale
    dq = mm_sliced(ds, k, passes) * scale
    return dq, dk, dv


@pytest.mark.parametrize("passes,meets", [(3, True), (1, False)])
def test_causal_attention_bwd_meets_tol(passes, meets):
    """dq, dk, dv of causal attention at B=1 H=2 T=256 Dh=128, inputs and
    upstream gradient ~ N(0, 1) as chip_smoke's _qkv makes them: each
    within BWD_TOL f32 (1e-4 of the float64 reference's max) of float64."""
    rng = np.random.default_rng(11)
    errs = []
    for _ in range(2):  # heads
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (256, 128)).astype(np.float32)) for _ in range(4))
        got = _attention_bwd(q, k, v, do, passes)
        qd, kd, vd = (x.double().requires_grad_() for x in (q, k, v))
        s = (qd @ kd.T) / 128 ** 0.5
        mask = torch.arange(256)[:, None] < torch.arange(256)[None, :]
        o = torch.softmax(s.masked_fill(mask, float("-inf")), -1) @ vd
        want = torch.autograd.grad(o, (qd, kd, vd), do.double())
        errs += [_rel(g, w) for g, w in zip(got, want)]
    assert (max(errs) <= BWD_TOL) is meets, errs
