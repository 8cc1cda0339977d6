"""The port's RNTN (deeplearning4j_tpu_torch/models/rntn.py) held against
the JAX package's, on the CPU.

Both packages draw the initial params from the same numpy seed, bucket the
same trees the same way, and are fed the same numpy inputs. At
num_hidden 8 and 25 (Socher's default) with 2 and 5 classes:

- ``_forward_tree`` on every padded bucket equals JAX's ``vmap`` of its
  scan within ``FWD_ATOL``;
- one ``_rntn_batch_step`` (params, AdaGrad history, loss) and a
  3-iteration ``fit`` (the ``losses`` list and the final params) agree
  within ``REL`` of each leaf's largest magnitude, run in float64 in both
  packages; in f32 the port's step is as close to a float64 step as
  JAX's f32 step is, and the f32 fit's losses follow JAX's at width 8.

Why float64 for the REL checks: in f32 neither package is reproducible
to REL. AdaGrad divides each gradient entry by sqrt(h + 1e-8), so an
entry with a small history turns rounding noise in its gradient into
parameter noise up to lr/1e-4 times larger, and a leaf that starts at 0
(b, bs) is one step's rounded gradient. Measured on this file's corpora:
JAX's jitted and op-by-op f32 steps part by up to 9.7e-5 of a leaf's max
(bs, width 25, 2 classes, after one epoch), and their 3-iteration fits
by up to 60% (width 25, 5 classes, 12 steps). Over many steps the fit is
chaotic even in float64: JAX's jitted and op-by-op float64 fits of the
4-bucket 5-class corpus part by 2e-5 of a leaf's max at width 25. So the
fits run on corpora of one bucket (3 steps), where JAX's float64 fits
agree with each other to 1e-13.
- ``predict_nodes`` on trees left out of the fit gives equal labels, and
  ``RNTNEval.stats()`` equal text.

tests/test_rntn.py's learning checks and tests/test_corpora.py's
raw-text pipeline run through the port as well.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models import rntn as jrntn
from deeplearning4j_tpu.nn.tree import Tree as JTree
from deeplearning4j_tpu.text.corpora import TreeVectorizer as JVectorizer
from deeplearning4j_tpu_torch.interop import rntn_params_from_numpy
from deeplearning4j_tpu_torch.models import rntn as trntn
from deeplearning4j_tpu_torch.models.rntn import RNTN, RNTNEval
from deeplearning4j_tpu_torch.nn.tree import Tree
from deeplearning4j_tpu_torch.text.corpora import TreeVectorizer

FWD_ATOL = 1e-6  # node states are tanh outputs, |x| <= 1
REL = 1e-5       # steps and fits, relative to each leaf's max

TRAIN_TEXT = (
    "an excellent wonderful movie . a terrible awful mess . "
    "a brilliant amazing film with a great cast . a boring dull disaster . "
    "the plot is not good but never boring . we loved the old house . "
    "this film is a bad and slow story about nothing . "
    "she quickly painted three beautiful houses by the river .")
# one bucket (8 leaves, 8 merges): 3 steps a fit, see the module docstring
FIT_TEXT = (
    "an excellent and wonderful movie . a terrible awful mess of a film . "
    "a brilliant amazing film with heart . "
    "a boring dull disaster for everyone . the plot is not good at all . "
    "we loved the old house . the slow story is very bad . "
    "she painted three beautiful houses .")
HELD_OUT_TEXT = (
    "a great and wonderful story . the dull film is awful . "
    "the cast loved the beautiful river .")


def _binary_corpus():
    """tests/test_rntn.py's toy sentiment task: 'good'-rooted trees are
    positive (1), 'bad'-rooted negative (0)."""
    pos = ["(1 (1 good) (1 movie))", "(1 (1 great) (1 film))",
           "(1 (1 good) (1 film))", "(1 (1 great) (1 movie))",
           "(1 (1 (1 very) (1 good)) (1 movie))"]
    neg = ["(0 (0 bad) (0 movie))", "(0 (0 awful) (0 film))",
           "(0 (0 bad) (0 film))", "(0 (0 awful) (0 movie))",
           "(0 (0 (0 very) (0 bad)) (0 movie))"]
    return pos + neg


def _binary_held_out():
    return ["(1 (1 great) (1 great))", "(0 (0 (0 very) (0 awful)) (0 film))",
            "(1 (1 (1 very) (1 great)) (1 (1 good) (1 movie)))",
            "(0 (0 unseen) (0 bad))"]


def _corpus(num_classes, text=TRAIN_TEXT):
    """(port train trees, JAX train trees, port held-out, JAX held-out);
    5 classes: labelled trees of ``text``."""
    if num_classes == 2:
        tr, ho = _binary_corpus(), _binary_held_out()
        return ([Tree.parse(s) for s in tr], [JTree.parse(s) for s in tr],
                [Tree.parse(s) for s in ho], [JTree.parse(s) for s in ho])
    tv, jv = TreeVectorizer(), JVectorizer()
    return (tv.get_trees_with_labels(text),
            jv.get_trees_with_labels(text),
            tv.get_trees_with_labels(HELD_OUT_TEXT),
            jv.get_trees_with_labels(HELD_OUT_TEXT))


CASES = [(8, 2), (8, 5), (25, 2), (25, 5)]


def _models(d, c, iterations=3, lr=0.1):
    kw = dict(num_hidden=d, num_classes=c, lr=lr, l2=1e-4,
              iterations=iterations, seed=7)
    return RNTN(device="cpu", **kw), jrntn.RNTN(**kw)


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= rel * float(np.max(np.abs(want), initial=0.0)), (what, err)


def _prepared(d, c):
    """Both models with their vocab built and the same initial params, and
    the port's buckets (host arrays, the same as JAX's)."""
    t_train, j_train, _, _ = _corpus(c)
    tm, jm = _models(d, c)
    tm._build_vocab(t_train)
    jm._build_vocab(j_train)
    assert tm.word_index == jm.word_index
    init = tm._init_params()
    jinit = jax.tree_util.tree_map(np.asarray, jm._init_params())
    for k in trntn.PARAM_KEYS:
        np.testing.assert_array_equal(init[k], jinit[k])
    buckets = tm._prepare(t_train)
    for a, b in zip(buckets, jm._prepare(j_train)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    return tm, jm, init, buckets


@pytest.mark.parametrize("d,c", CASES)
def test_forward_tree_on_padded_buckets_equals_jax(d, c):
    tm, _, init, buckets = _prepared(d, c)
    params = rntn_params_from_numpy(init, device="cpu")
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    for bucket in buckets:
        leaf, mrg, mmask, _, _ = tm._on_device(bucket)
        lb = leaf.shape[1]
        got = trntn._forward_tree(params, leaf, mrg, mmask, lb)
        want = jax.vmap(lambda li, m, mm: jrntn._forward_tree(
            jparams, li, m, mm, lb))(*(jnp.asarray(a) for a in bucket[:3]))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FWD_ATOL, rtol=0)


def _jax_state(init, buckets, lr, l2, epochs):
    """JAX's params and AdaGrad history after ``epochs`` passes over the
    buckets, from ``init``."""
    p = {k: jnp.asarray(v) for k, v in init.items()}
    h = {k: jnp.zeros_like(v) for k, v in p.items()}
    for _ in range(epochs):
        for b in buckets:
            p, h, _ = jrntn._rntn_batch_step(
                p, h, *(jnp.asarray(a) for a in b), lr, l2)
    return ({k: np.asarray(v) for k, v in p.items()},
            {k: np.asarray(v) for k, v in h.items()})


def _port_step(params, hist, tm, bucket, dtype=torch.float32):
    p = {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in params.items()}
    h = {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in hist.items()}
    out = trntn._rntn_batch_step(p, h, *tm._on_device(bucket), tm.lr, tm.l2)
    return ({k: v.numpy() for k, v in out[0].items()},
            {k: v.numpy() for k, v in out[1].items()}, float(out[2]))


def _jax_step(params, hist, tm, bucket):
    p, h, loss = jrntn._rntn_batch_step(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in hist.items()},
        *(jnp.asarray(a) for a in bucket), tm.lr, tm.l2)
    return ({k: np.asarray(v) for k, v in p.items()},
            {k: np.asarray(v) for k, v in h.items()}, float(loss))


def _wide(tree):
    return {k: np.asarray(v, np.float64) for k, v in tree.items()}


@pytest.mark.parametrize("d,c", CASES)
def test_batch_step_equals_jax(d, c):
    """Every bucket's step in float64 in both packages, from the initial
    params with a zero history (AdaGrad's first step) and from JAX's
    state after one epoch."""
    tm, _, init, buckets = _prepared(d, c)
    zero = {k: np.zeros_like(v) for k, v in init.items()}
    states = [(init, zero), _jax_state(init, buckets, tm.lr, tm.l2, 1)]
    for params, hist in states:
        params, hist = _wide(params), _wide(hist)
        for bucket in buckets:
            p, h, loss = _port_step(params, hist, tm, bucket, torch.float64)
            with jax.enable_x64(True):
                jp, jh, jloss = _jax_step(params, hist, tm, bucket)
            assert jp["V"].dtype == np.float64
            _close(loss, jloss, what="loss")
            for k in trntn.PARAM_KEYS:
                _close(p[k], jp[k], what=f"params[{k}]")
                _close(h[k], jh[k], what=f"hist[{k}]")


def _pooled_rms(got, ref):
    """RMS over every leaf's entries of (got - ref) / max|ref|."""
    errs = [((got[k] - ref[k]) / np.max(np.abs(ref[k]))).ravel()
            for k in trntn.PARAM_KEYS]
    return float(np.sqrt(np.mean(np.concatenate(errs) ** 2)))


@pytest.mark.parametrize("d,c", CASES)
def test_f32_step_as_accurate_as_jax(d, c):
    """The f32 step from the initial params and a zero history: the
    port's is no further from a float64 step than JAX's f32 step is (RMS
    over all leaves, each scaled by its max, within twice JAX's), and its
    loss is within REL of JAX's."""
    tm, _, init, buckets = _prepared(d, c)
    zero = {k: np.zeros_like(v) for k, v in init.items()}
    for bucket in buckets:
        p, _, loss = _port_step(init, zero, tm, bucket)
        jp, _, jloss = _jax_step(init, zero, tm, bucket)
        p64, _, _ = _port_step(init, zero, tm, bucket, torch.float64)
        _close(loss, jloss, what="loss")
        assert _pooled_rms(p, p64) <= 2 * _pooled_rms(jp, p64)


@pytest.fixture
def float64_fits(monkeypatch):
    """Both packages' fits in float64: the port's params go to the device
    as f64, JAX's initial params are widened and traced under x64."""
    from deeplearning4j_tpu_torch import interop

    orig = interop.rntn_params_from_numpy

    def f64(params, device=None):
        return {k: v.double() for k, v in orig(params, device).items()}

    monkeypatch.setattr(interop, "rntn_params_from_numpy", f64)

    def fit(tm, jm, t_train, j_train):
        tm.fit(t_train)
        jinit = jm._init_params
        jm._init_params = lambda: {k: np.asarray(v, np.float64)
                                   for k, v in jinit().items()}
        with jax.enable_x64(True):
            jm._init_params = (lambda wide: lambda: {
                k: jnp.asarray(v) for k, v in wide().items()})(
                jm._init_params)
            jm.fit(j_train)
        monkeypatch.setattr(interop, "rntn_params_from_numpy", orig)

    return fit


@pytest.mark.parametrize("d,c", CASES)
def test_fit_predict_and_eval_equal_jax(d, c, float64_fits):
    t_train, j_train, t_held, j_held = _corpus(c, FIT_TEXT)
    tm, jm = _models(d, c)
    float64_fits(tm, jm, t_train, j_train)
    assert len(tm.losses) == 3 and len(tm._prepare(t_train)) == 1
    assert tm.params["V"].dtype == jm.params["V"].dtype == np.float64
    _close(tm.losses, jm.losses, what="losses")
    for k in trntn.PARAM_KEYS:
        assert isinstance(tm.params[k], np.ndarray)
        _close(tm.params[k], jm.params[k], what=k)
    for a, b in zip(t_held, j_held):
        p, g = tm.predict_nodes(a)
        jp, jg = jm.predict_nodes(b)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(g, jg)
        assert tm.predict_root(a) == jm.predict_root(b)
    ev, jev = RNTNEval(), jrntn.RNTNEval()
    ev.eval(tm, t_held + t_train)
    jev.eval(jm, j_held + j_train)
    assert ev.stats() == jev.stats()


def test_f32_fit_losses_follow_jax_at_width_8():
    """The f32 fit where JAX agrees with itself (one bucket of 3 steps an
    epoch, num_hidden 8): losses within REL."""
    t_train, j_train, _, _ = _corpus(2)
    tm, jm = _models(8, 2)
    tm.fit(t_train)
    jm.fit(j_train)
    assert tm.params["V"].dtype == np.float32
    _close(tm.losses, jm.losses, what="losses")


def test_port_evaluates_jax_weights():
    """A port model given a JAX model's params and vocab predicts what the
    JAX model predicts, node for node."""
    t_train, j_train, t_held, j_held = _corpus(5)
    jm = jrntn.RNTN(num_hidden=25, iterations=2, seed=1)
    jm.fit(j_train)
    tm = RNTN(device="cpu")
    tm.params = {k: np.asarray(v) for k, v in jm.params.items()}
    tm.word_index = dict(jm.word_index)
    for a, b in zip(t_held + t_train[:3], j_held + j_train[:3]):
        np.testing.assert_array_equal(tm.predict_nodes(a)[0],
                                      jm.predict_nodes(b)[0])


def test_rntn_params_from_numpy_checks_the_key_set():
    params = RNTN(device="cpu", num_hidden=4)
    params._build_vocab([Tree.parse("(1 (0 a) (1 b))")])
    init = params._init_params()
    out = rntn_params_from_numpy(init, device="cpu")
    assert set(out) == set(trntn.PARAM_KEYS)
    assert all(v.dtype == torch.float32 for v in out.values())
    for bad in ({k: v for k, v in init.items() if k != "bs"},
                dict(init, extra=np.zeros(1))):
        with pytest.raises(ValueError, match="RNTN params"):
            rntn_params_from_numpy(bad, device="cpu")


def test_rntn_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert RNTN().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            RNTN()


# ----------------------------------- tests/test_rntn.py TestRNTN ----

def _sentiment_trees():
    return [Tree.parse(s) for s in _binary_corpus()]


class TestRNTN:
    def test_learns_toy_sentiment(self):
        trees = _sentiment_trees()
        model = RNTN(num_hidden=8, num_classes=2, lr=0.25, iterations=60,
                     l2=1e-5, seed=0, device="cpu")
        model.fit(trees)
        assert model.losses[-1] < model.losses[0]
        ev = RNTNEval()
        ev.eval(model, trees)
        assert ev.root_accuracy() >= 0.9, ev.stats()
        assert ev.node_accuracy() >= 0.8, ev.stats()

    def test_predict_root_unseen_composition(self):
        trees = _sentiment_trees()
        model = RNTN(num_hidden=8, num_classes=2, lr=0.25, iterations=60,
                     l2=1e-5, seed=0, device="cpu")
        model.fit(trees)
        t = Tree.parse("(1 (1 great) (1 great))")
        assert model.predict_root(t) in (0, 1)

    def test_eval_stats_format(self):
        assert "node acc" in RNTNEval().stats()


def test_rntn_trains_from_raw_text():
    """tests/test_corpora.py's raw sentences → trees → RNTN.fit."""
    sents = ("an excellent wonderful movie . a terrible awful mess . "
             "a brilliant amazing film . a boring dull disaster .")
    trees = TreeVectorizer().get_trees_with_labels(sents)
    assert len(trees) == 4
    model = RNTN(num_hidden=8, iterations=8, lr=0.05, seed=3, device="cpu")
    model.fit(trees)
    assert model.losses[-1] < model.losses[0]
