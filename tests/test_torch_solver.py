"""The port's solvers, listeners and net-state checkpoints
(deeplearning4j_tpu_torch/optimize/solver.py, terminations.py,
listeners.py, scaleout/ckpt/net_state.py and the net half of
scaleout/ckpt/checkpointer.py) held against the JAX package on the CPU.

Solver parity runs each algorithm on a deterministic objective, the
output head's loss over fixed top-of-stack activations, from JAX-inited
params; the per-iteration keys are package-local and this objective
draws nothing, so the two runs see the same function.

Tolerances: score histories 1e-6 absolute (every score within a few f32
ulps); final params 1e-5 of the largest |param| (L-BFGS's steps grow the
params to several units; its history turns f32 rounding in the line
search into ~7e-6 absolute after 10 iterations). Checkpoint round trips
are exact (``torch.equal``, ``np.array_equal``).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn import params as jparams_mod
from deeplearning4j_tpu.nn.layers import output as jout
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import listeners as jlisteners
from deeplearning4j_tpu.optimize import solver as jsolver
from deeplearning4j_tpu.optimize import terminations as jterm
from deeplearning4j_tpu.scaleout.ckpt import Checkpointer as JCheckpointer
from deeplearning4j_tpu.telemetry.registry import MetricsRegistry as JReg
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.layers import output as tout
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import pallas_kernels as tpk
from deeplearning4j_tpu_torch.optimize import listeners as tlisteners
from deeplearning4j_tpu_torch.optimize import solver as tsolver
from deeplearning4j_tpu_torch.optimize import terminations as tterm
from deeplearning4j_tpu_torch.scaleout.ckpt import Checkpointer, \
    CheckpointIterationListener, capture_net_state, rebuild_net
from deeplearning4j_tpu_torch.scaleout.ckpt.net_state import key_to_words, \
    words_to_key
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

SCORE_ATOL = 1e-6
PARAM_REL = 1e-5
ALGOS = ["GRADIENT_DESCENT", "ITERATION_GRADIENT_DESCENT",
         "CONJUGATE_GRADIENT", "LBFGS", "HESSIAN_FREE"]


# -------------------------------------------------------- terminations ----

@pytest.mark.parametrize("name,args,case", [
    ("EpsTermination", (), (1.0, 1.00005, 9.0)),
    ("EpsTermination", (), (1.0, 1.1, 9.0)),
    ("EpsTermination", (), (5e-6, 0.0, 9.0)),
    ("EpsTermination", (), (5e-5, 0.0, 9.0)),
    ("EpsTermination", (1e-2, 1e-3), (1.0, 1.005, 9.0)),
    ("Norm2Termination", (), (1.0, 2.0, 5e-7)),
    ("Norm2Termination", (), (1.0, 2.0, 2e-6)),
    ("Norm2Termination", (1e-2,), (1.0, 2.0, 5e-3)),
    ("ZeroDirection", (), (1.0, 2.0, 0.0)),
    ("ZeroDirection", (), (1.0, 2.0, 1e-30)),
])
def test_terminations_match_jax(name, args, case):
    got = getattr(tterm, name)(*args).terminate(*case)
    want = getattr(jterm, name)(*args).terminate(*case)
    assert got is want


# --------------------------------------------------------- line search ----

@pytest.mark.parametrize("scale", [0.1, 1.0, 30.0, 1e4])
def test_backtrack_line_search_on_a_quadratic(scale):
    """f(x) = ½ xᵀAx along -g: the accepted step equals JAX's (f32), is 0
    when no trial decreases f (ascent direction), and the Armijo condition
    holds at it."""
    rng = np.random.RandomState(int(scale) % 7)
    m = rng.randn(6, 6).astype(np.float32)
    a = (m @ m.T + np.eye(6, dtype=np.float32)) * scale
    x = rng.randn(6).astype(np.float32)
    g = a @ x
    tA, tx = torch.from_numpy(a), torch.from_numpy(x)

    def tf(z):
        return 0.5 * z @ tA @ z

    def jf(z):
        return 0.5 * z @ jnp.asarray(a) @ z

    for direction in (-g, g):
        got = tsolver.backtrack_line_search(
            tf, tx, float(tf(tx)), torch.from_numpy(g),
            torch.from_numpy(direction), max_iterations=20)
        want = jsolver.backtrack_line_search(
            jf, jnp.asarray(x), jf(jnp.asarray(x)), jnp.asarray(g),
            jnp.asarray(direction), max_iterations=20)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(want)
        if direction is g:
            assert float(got) == 0.0
        else:
            s = float(got)
            assert s > 0
            assert float(tf(tx + s * torch.from_numpy(direction))) <= \
                float(tf(tx)) + 1e-4 * s * float(-(g @ g))


# -------------------------------------------------------------- solver ----

def _head(algo, step_function="default", num_iterations=10, n=16):
    kw = dict(layer_type="OUTPUT", n_in=12, n_out=4,
              activation_function="softmax", loss_function="MCXENT",
              optimization_algo=algo, num_iterations=num_iterations,
              step_function=step_function, lr=0.1)
    jc = jconf.NeuralNetConfiguration(**kw)
    tc = tconf.NeuralNetConfiguration(**kw)
    p = jax.tree_util.tree_map(np.asarray, jparams_mod.init_layer_params(
        jax.random.PRNGKey(1), jc))
    rng = np.random.RandomState(0)
    top = rng.randn(n, 12).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)]

    def jscore(q, key):
        return jout.output_loss(jc, q, jnp.asarray(top), jnp.asarray(y))

    def tscore(q, key):
        return tout.output_loss(tc, q, torch.from_numpy(top),
                                torch.from_numpy(y))

    return tc, jc, p, tscore, jscore


def _tparams(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _param_rel(got, want) -> float:
    scale = max(max(float(np.abs(np.asarray(v)).max()) for v in want.values()),
                1.0)
    return max(float(np.abs(got[k].numpy() - np.asarray(want[k])).max())
               for k in want) / scale


@pytest.mark.parametrize("step_function", ["default", "gradient"])
@pytest.mark.parametrize("algo", ALGOS)
def test_solver_matches_jax(algo, step_function):
    """Score history and final params of each algorithm against JAX's
    Solver, with the Armijo search (step function "default") and without
    it ("gradient", which ignores the step size)."""
    tc, jc, p, tscore, jscore = _head(algo, step_function)
    js = jsolver.Solver(jc, jscore)
    want = js.optimize(jax.tree_util.tree_map(jnp.asarray, p),
                       jax.random.PRNGKey(0))
    ts = tsolver.Solver(tc, tscore)
    got = ts.optimize(_tparams(p), 0)
    assert sorted(got) == sorted(want)
    assert len(ts.score_history) == len(js.score_history) == 10
    np.testing.assert_allclose(ts.score_history, js.score_history,
                               atol=SCORE_ATOL, rtol=0)
    assert ts.score_history[-1] < ts.score_history[0]
    assert _param_rel(got, want) <= PARAM_REL
    assert all(v.dtype == torch.float32 for v in got.values())


def test_solver_terminates_early_like_jax():
    """Random labels on 256 points: the loss has an interior minimum,
    and EpsTermination stops both L-BFGS runs after the same
    iteration."""
    tc, jc, p, tscore, jscore = _head("LBFGS", num_iterations=200, n=256)
    js = jsolver.Solver(jc, jscore)
    js.optimize(jax.tree_util.tree_map(jnp.asarray, p),
                jax.random.PRNGKey(0))
    ts = tsolver.Solver(tc, tscore)
    ts.optimize(_tparams(p), 0)
    assert len(ts.score_history) == len(js.score_history) < 200


def test_solver_grad_fn_seam_and_algo_override():
    """``grad_fn=`` replaces autograd (here: twice the true gradient, so
    the run differs from the plain one) and ``algo=`` overrides the
    conf's algorithm; each key a solver iteration sees is fresh."""
    tc, jc, p, tscore, jscore = _head("LBFGS", num_iterations=4)
    keys = []

    def tgrad(q, key):
        keys.append(key)
        leaves = {k: v.detach().requires_grad_() for k, v in q.items()}
        with torch.enable_grad():
            s = tscore(leaves, key)
            gs = torch.autograd.grad(s, list(leaves.values()))
        return {k: 2 * g for k, g in zip(leaves, gs)}

    def jgrad(q, key):
        return jax.tree_util.tree_map(lambda g: 2 * g,
                                      jax.grad(jscore)(q, key))

    ts = tsolver.Solver(tc, tscore, grad_fn=tgrad)
    got = ts.optimize(_tparams(p), 5,
                      algo=tconf.OptimizationAlgorithm
                      .ITERATION_GRADIENT_DESCENT)
    js = jsolver.Solver(jc, jscore, grad_fn=jgrad)
    want = js.optimize(jax.tree_util.tree_map(jnp.asarray, p),
                       jax.random.PRNGKey(5),
                       algo=jconf.OptimizationAlgorithm
                       .ITERATION_GRADIENT_DESCENT)
    assert len(keys) == len(set(keys)) == 4
    np.testing.assert_allclose(ts.score_history, js.score_history,
                               atol=SCORE_ATOL, rtol=0)
    assert _param_rel(got, want) <= PARAM_REL
    plain = tsolver.Solver(tc, tscore).optimize(
        _tparams(p), 5,
        algo=tconf.OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT)
    assert not torch.equal(plain["W"], got["W"])


def test_hessian_free_raises_through_the_kernel_wrapper():
    """An objective that reaches ``FusedDense`` has no forward-mode rule:
    HESSIAN_FREE raises instead of returning a wrong product."""
    tc, _, p, _, _ = _head("HESSIAN_FREE", num_iterations=2)
    top = torch.from_numpy(np.random.RandomState(1).randn(8, 12)
                           .astype(np.float32))

    def through_k1(q, key):
        return tpk.fused_dense(top, q["W"], q["b"], "tanh").square().mean()

    with pytest.raises(RuntimeError):
        tsolver.Solver(tc, through_k1).optimize(_tparams(p), 0)


# ----------------------------------------------------------- listeners ----

class _Raising:
    def __init__(self):
        self.calls = 0

    def __call__(self, model, iteration, score):
        self.calls += 1
        raise RuntimeError("listener failure")


class _Closing:
    def __init__(self):
        self.closed = 0

    def __call__(self, model, iteration, score):
        pass

    def close(self):
        self.closed += 1


def test_dispatch_logs_and_skips_a_raising_listener(caplog):
    bad, seen = _Raising(), tlisteners.CollectScoresListener()
    with caplog.at_level(logging.ERROR):
        tlisteners.dispatch_listeners([bad, seen], None, 3, 0.5)
    assert bad.calls == 1 and seen.scores == [(3, 0.5)]
    assert "failed at iteration 3" in caplog.text
    closing = _Closing()
    boom = type("Boom", (), {"close": lambda self: 1 / 0})()
    tlisteners.close_listeners([boom, closing, object()])
    assert closing.closed == 1
    both = tlisteners.ComposableIterationListener([seen, closing])
    both(None, 4, 0.25)
    both.close()
    assert seen.scores[-1] == (4, 0.25) and closing.closed == 2


def test_solver_closes_listeners_when_the_objective_raises():
    tc, _, p, _, _ = _head("GRADIENT_DESCENT", num_iterations=3)
    closing, bad = _Closing(), _Raising()

    def failing(q, key):
        raise ValueError("objective failure")

    with pytest.raises(ValueError, match="objective failure"):
        tsolver.Solver(tc, failing, listeners=[closing]).optimize(
            _tparams(p), 0)
    assert closing.closed == 1
    _, _, _, tscore, _ = _head("GRADIENT_DESCENT", num_iterations=3)
    s = tsolver.Solver(tc, tscore, listeners=[bad, closing])
    s.optimize(_tparams(p), 0)
    assert bad.calls == 3 and closing.closed == 2


def _mlp_conf(package, num_iterations=1, dropout=0.0):
    conf = jconf if package == "jax" else tconf
    return (conf.NeuralNetConfiguration.Builder()
            .n_in(4).n_out(8).activation_function("tanh").lr(0.05)
            .momentum(0.9).use_ada_grad(True).dropout(dropout)
            .num_iterations(num_iterations).seed(7)
            .list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())


def _xy(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)])


@pytest.mark.parametrize("how", ["fit", "fit_epochs"])
def test_network_listeners_fire_once_per_iteration_with_fresh_params(how):
    """Each iteration dispatches once, after the facade holds that
    iteration's params and updater state; the chain is closed when the
    loop ends and when it raises."""
    x, y = _xy()
    net = MultiLayerNetwork(_mlp_conf("port", num_iterations=3),
                            device="cpu").init()
    seen = []

    def snap(model, iteration, score):
        seen.append((iteration, score, model.params().clone(),
                     model._train_state[0]["v"]["W"].clone()))

    closing, bad = _Closing(), _Raising()
    net.set_listeners([snap, bad, closing])
    if how == "fit":
        net.fit(x, y)
    else:
        net.fit_epochs(DataSet(x, y), num_epochs=3, batch_size=8)
    want = 3 if how == "fit" else 6
    assert [s[0] for s in seen] == list(range(1, want + 1))
    assert bad.calls == want and closing.closed == 1
    assert torch.equal(seen[-1][2], net.params())
    assert torch.equal(seen[-1][3], net._train_state[0]["v"]["W"])
    assert not torch.equal(seen[0][2], seen[-1][2])
    assert all(np.isfinite(s[1]) for s in seen)
    with pytest.raises(ValueError, match="No labels"):
        net.fit(DataSet(x, None))
    assert closing.closed == 2


def test_network_listener_scores_match_jax():
    """The scores ``fit`` hands its listeners equal JAX's from the same
    params."""
    x, y = _xy(seed=1)
    jnet = JNet(_mlp_conf("jax", num_iterations=4)).init()
    jcol = jlisteners.CollectScoresListener()
    jnet.set_listeners([jcol])
    tnet = MultiLayerNetwork(
        _mlp_conf("port", num_iterations=4), device="cpu",
        params=interop.mln_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jnet.params_tree),
            device="cpu"))
    tcol = tlisteners.CollectScoresListener()
    tnet.set_listeners([tcol])
    jnet.fit(x, y)
    tnet.fit(x, y)
    assert [i for i, _ in tcol.scores] == [i for i, _ in jcol.scores]
    np.testing.assert_allclose([s for _, s in tcol.scores],
                               [s for _, s in jcol.scores], atol=1e-5,
                               rtol=0)


def _metric_names(snapshot):
    return {kind: sorted((r["name"], r.get("count", r.get("value")))
                         for r in rows)
            for kind, rows in snapshot.items()}


def test_metrics_listener_names_match_jax():
    treg, jreg = MetricsRegistry(), JReg()
    tl = tlisteners.MetricsIterationListener(registry=treg, prefix="pre")
    jl = jlisteners.MetricsIterationListener(registry=jreg, prefix="pre")
    for i, s in enumerate((3.0, 2.0, 1.5)):
        tl(None, i, s)
        jl(None, i, s)
    tsnap, jsnap = treg.snapshot(), jreg.snapshot()
    assert _metric_names(tsnap) == _metric_names(jsnap)
    assert [r["name"] for r in tsnap["histograms"]] == ["pre_iteration_ms"]
    assert tsnap["histograms"][0]["count"] == 2
    with pytest.raises(NotImplementedError, match="slice 9"):
        tlisteners.MetricsIterationListener(registry=treg,
                                            step_log_path="steps.jsonl")
    timing = tlisteners.TimingIterationListener(registry=treg)

    class Tracker:
        total = 0.0

        def increment(self, name, value):
            assert name == "job_ms_total"
            Tracker.total += value

    timing.tracker = Tracker()
    for i in range(3):
        timing(None, i, 1.0)
    assert len(timing.timings_ms) == 2
    assert Tracker.total == pytest.approx(timing.total_ms())
    assert timing.p50_ms() <= timing.p95_ms()


# ----------------------------------------------------------- net state ----

def test_key_words_round_trip():
    for key in (0, 42, (1 << 32) + 5, (1 << 64) - 1, 0x9E3779B97F4A7C15):
        words = key_to_words(key)
        assert words.dtype == np.uint32 and words.shape == (2,)
        assert words_to_key(words) == key
    np.testing.assert_array_equal(key_to_words(42),
                                  np.asarray(jax.random.PRNGKey(42)))
    with pytest.raises(ValueError, match="two uint32"):
        words_to_key(np.zeros(4, np.uint32))


def test_checkpoint_listener_round_trip_and_resume(tmp_path):
    """Saved every 5 iterations through the listener chain, rebuilt by
    ``restore_net`` from the checkpoint alone: params, updater state,
    iteration and key equal to the live net's at that step, and the
    resumed run's scores equal an uninterrupted run's (the dropout draws
    come from the restored key)."""
    x, y = _xy()
    conf = _mlp_conf("port", num_iterations=5, dropout=0.3)

    net_a = MultiLayerNetwork(conf, device="cpu").init()
    scores_a = tlisteners.CollectScoresListener()
    net_a.set_listeners([scores_a])
    net_a.fit(x, y)
    net_a.fit(x, y)

    ck = Checkpointer(str(tmp_path / "ck"), registry=MetricsRegistry())
    net_b = MultiLayerNetwork(conf, device="cpu").init()
    listener = CheckpointIterationListener(ck, save_every=5)
    net_b.set_listeners([listener])
    net_b.fit(x, y)
    assert listener.saved_steps == [5] and ck.latest_step() == 5

    net_c, it = ck.restore_net(device="cpu")
    assert it == 5 and net_c._keys._key == net_b._keys._key
    assert net_c.conf == net_b.conf
    for got, want in zip(net_c.params_tree, net_b.params_tree):
        assert all(torch.equal(got[k], want[k]) for k in want)
    for got, want in zip(net_c._train_state, net_b._train_state):
        for part in ("hist", "v"):
            assert all(torch.equal(got[part][k], want[part][k])
                       for k in want[part])
    scores_c = tlisteners.CollectScoresListener()
    net_c.set_listeners([scores_c])
    net_c.fit(x, y)
    assert scores_c.scores == [(i, s) for i, s in scores_a.scores if i > 5]
    assert torch.equal(net_c.params(), net_a.params())

    tree, meta = capture_net_state(net_a)
    rebuilt = rebuild_net(tree, meta, device="cpu")
    assert torch.equal(rebuilt.params(), net_a.params())
    assert rebuilt._iteration == 10


def _same_net_state(tree_a, tree_b):
    a = jax.tree_util.tree_map(np.asarray, tree_a)
    b = jax.tree_util.tree_map(np.asarray, tree_b)
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("key_flavor", ["raw", "typed"])
def test_jax_net_state_restores_in_the_port(tmp_path, key_flavor):
    x, y = _xy(seed=2)
    jnet = JNet(_mlp_conf("jax", num_iterations=3)).init()
    if key_flavor == "typed":
        jnet._keys._key = jax.random.key(7)
    jnet.fit(x, y)
    JCheckpointer(str(tmp_path), registry=JReg()).save_net(jnet)
    net, it = Checkpointer(str(tmp_path), registry=MetricsRegistry()
                           ).restore_net(device="cpu")
    assert it == jnet._iteration == 3
    assert net.conf.to_json() == jnet.conf.to_json()
    _same_net_state(interop.tree_to_numpy(net.params_tree), jnet.params_tree)
    _same_net_state(interop.tree_to_numpy(net._train_state),
                    jnet._train_state)
    raw = (jax.random.key_data(jnet._keys._key) if key_flavor == "typed"
           else jnet._keys._key)
    np.testing.assert_array_equal(key_to_words(net._keys._key),
                                  np.asarray(raw))


def test_port_net_state_restores_in_jax(tmp_path):
    x, y = _xy(seed=3)
    net = MultiLayerNetwork(_mlp_conf("port", num_iterations=3),
                            device="cpu").init()
    net.fit(x, y)
    Checkpointer(str(tmp_path), registry=MetricsRegistry()).save_net(net)
    jnet, it = JCheckpointer(str(tmp_path), registry=JReg()).restore_net()
    assert it == net._iteration == 3
    assert jnet.conf.to_json() == net.conf.to_json()
    _same_net_state(jnet.params_tree, interop.tree_to_numpy(net.params_tree))
    _same_net_state(jnet._train_state,
                    interop.tree_to_numpy(net._train_state))
    np.testing.assert_array_equal(np.asarray(jnet._keys._key),
                                  key_to_words(net._keys._key))
    # the restored JAX net trains on from the port's state
    jnet.fit(x, y)
    assert jnet._iteration == 6


def test_restore_net_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    net = MultiLayerNetwork(_mlp_conf("port"), device="cpu").init()
    ck = Checkpointer(str(tmp_path), registry=MetricsRegistry())
    ck.save_net(net)
    tree, meta = capture_net_state(net)
    for call in (lambda: ck.restore_net(), lambda: rebuild_net(tree, meta)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
