"""The port's ``utils.retrace_guard`` held to the JAX package's tests
(mirroring ``tests/test_retrace_guard.py``) over the port's compile
events: Dynamo graph compiles (``torch.compile(backend="eager")``, which
traces but generates no code) and ``nvcc`` builds (``ops._kernels.build``,
the compiler faked here: the host has no ``nvcc``).

JAX's weak-type drift has the port's counterpart in a Python scalar where
a tensor was traced (Dynamo specializes on the scalar). JAX's pinned
budgets of its composed, pipeline and DP-sync steps have one counterpart
here, the eager LM step at 0: no port step compiles anything after its
first call (``retrace_guard(0)`` holds the card's warmed steps in
``chip_smoke.py``)."""

import os
import subprocess

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

from deeplearning4j_tpu_torch.utils.retrace_guard import (
    RetraceBudgetExceeded,
    compiles_so_far,
    recent_compiles,
    retrace_guard,
    signature_diff,
)


@pytest.fixture
def retrace_budget():
    """The guard as a fixture, as JAX's conftest gives it."""
    return retrace_guard


def _compiled(fn, **kw):
    return torch.compile(fn, backend="eager", **kw)


def test_counter_counts_real_compiles():
    before = compiles_so_far()
    f = _compiled(lambda x: x * 3 + 1)
    f(torch.ones(5))
    assert compiles_so_far() > before


def test_shape_unstable_step_fails_the_guard():
    f = _compiled(lambda x: (x * 2).sum(), dynamic=False)
    f(torch.ones(3))
    with pytest.raises(RetraceBudgetExceeded, match="retrace budget"):
        with retrace_guard(1, label="shape-unstable"):
            for n in range(4, 9):
                f(torch.ones(n))


def test_guard_does_not_mask_inner_exceptions():
    with pytest.raises(ValueError, match="boom"):
        with retrace_guard(0):
            raise ValueError("boom")


def test_scalar_drift_is_caught():
    """The port's weak-type drift: a Python scalar where a tensor was
    traced compiles a second graph."""
    f = _compiled(lambda x, s: x * s)
    x = torch.ones(4)
    f(x, torch.tensor(2.0))
    with pytest.raises(RetraceBudgetExceeded):
        with retrace_guard(0, label="scalar drift"):
            f(x, 2.0)


def test_blown_budget_reports_what_recompiled():
    """The error names the recompiled function with its signature and
    diffs it against the function's previous compile."""

    def distinctly_named_step(x, s):
        return x * s

    f = _compiled(distinctly_named_step)
    x = torch.ones(7)
    compiles_so_far()
    f(x, torch.tensor(2.0))
    with pytest.raises(RetraceBudgetExceeded) as ei:
        with retrace_guard(0, label="forensics"):
            f(x, 2.0)
    msg = str(ei.value)
    assert "compiled in this region:" in msg
    assert "distinctly_named_step" in msg
    assert "float 2.0" in msg
    assert "vs previous compile:" in msg
    assert "arg 1: f32[] -> float 2.0" in msg


def test_shape_change_names_the_argument():
    """retrace_guard(0) fails a shape-unstable compiled function and
    names the argument that changed."""

    def shape_unstable_fn(x):
        return (x * 2).sum()

    f = _compiled(shape_unstable_fn)
    f(torch.ones(3))
    with pytest.raises(RetraceBudgetExceeded) as ei:
        with retrace_guard(0, label="shapes"):
            f(torch.ones(5))
    assert "arg 0: f32[3] -> f32[5]" in str(ei.value)


def test_guard_records_signatures_even_under_budget():
    f = _compiled(lambda x: x + 3)
    compiles_so_far()
    with retrace_guard(2, label="cold region") as guard:
        f(torch.ones(9))
    assert guard.count >= 1
    assert any("f32[9]" in rec["signature"] for rec in guard.compiled)
    assert recent_compiles()


def test_signature_diff_is_positional():
    a, b = "f32[4], f32[]", "f32[4], float 2.0"
    assert signature_diff(a, b) == "arg 1: f32[] -> float 2.0"
    assert signature_diff(a, a) == "signatures identical"
    assert signature_diff(a, "f32[4]") == "arg count changed: 2 -> 1"
    assert signature_diff("", "") == "signatures unparsed"


def test_kernel_builds_are_compile_events(tmp_path, monkeypatch):
    """An nvcc build counts once, with the source's hash and the flags;
    a library already built is loaded, not compiled."""
    from deeplearning4j_tpu_torch.ops import _kernels

    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "run", fake_run)
    with retrace_guard(1, label="cold build") as guard:
        path = _kernels.build("lstm_gates")
    assert guard.count == 1 and len(calls) == 1
    (rec,) = guard.compiled
    digest = path.stem.rsplit("_", 1)[-1]
    assert rec["name"] == "nvcc:lstm_gates"
    assert rec["signature"].startswith(f"lstm_gates.cu@{digest}, ")
    assert "arch=compute_90a,code=sm_90a" in rec["signature"]
    with retrace_guard(0, label="warm build"):
        assert _kernels.build("lstm_gates") == path
    assert len(calls) == 1


def test_eager_lm_step_budget(retrace_budget):
    """The port's LM training step compiles nothing after its first
    call."""
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm

    params = tlm.init_lm_params(torch.Generator().manual_seed(0), 32, 16, 2,
                                2, 32, n_layers=2, device="cpu")
    step = tlm.make_single_device_train_step(2, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 32, (2, 17)))
    tk, tg = toks[:, :-1], toks[:, 1:]
    params, loss = step(params, tk, tg)
    with retrace_budget(0, label="lm steady state"):
        for _ in range(3):
            params, loss = step(params, tk, tg)
    assert np.isfinite(float(loss))
