"""The port's data-parallel Word2Vec (``make_sharded_sgns_step``,
``make_sharded_hs_step``, ``Word2Vec(mesh=...)`` in
deeplearning4j_tpu_torch/models/word2vec.py) held against the JAX
package's ``shard_map`` steps on a 4-device ("data",) mesh of the tests'
CPU devices.

Four gloo ranks start ONCE for the module (tests/_torch_parallel_ranks.py,
torch and the port only). JAX's per-shard negatives — the step key folded
with the shard index, then the draw of ``_sample_negs`` — are computed here
and put in at the port's ``_neg_slots`` draw point on each rank.

Tolerances: one step to ``STEP_TOL`` of each table's largest magnitude, a
fit to ``EPOCH_TOL`` absolute (tests/test_torch_word2vec.py's).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.models import word2vec as jw2v
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.text.sentence_iterator import \
    CollectionSentenceIterator as JSentences
from deeplearning4j_tpu.text.tokenization import \
    DefaultTokenizerFactory as JTokenizer
from deeplearning4j_tpu_torch.models import word2vec as tw2v

WORLD = 4
STEP_TOL = 1e-6    # of the table's max |value|
EPOCH_TOL = 1e-5   # absolute
SPAWN_TIMEOUT_S = 240
V, D, BG, NEG, SLOTS, LMAX = 40, 16, 64, 5, 4096, 6
N_PAD = 10         # padded tail pairs of the HS batch
KEY = 7
LR = 0.05
FIT_KW = dict(layer_size=16, window=3, negative=5, sample=1e-3,
              batch_size=250, iterations=2, seed=1, lr=0.05,
              use_hierarchic_softmax=True, shared_negatives=25)


class PythonTokenizer(JTokenizer):
    """A subclass: the JAX vocab builds on the python path, as the
    ranks' does."""


def _corpus():
    fruit = "apple banana cherry fruit sweet juice"
    tech = "cpu gpu chip silicon compute memory"
    rng = np.random.default_rng(0)
    out = []
    for _ in range(40):
        out.append(" ".join(rng.permutation(fruit.split()).tolist()))
        out.append(" ".join(rng.permutation(tech.split()).tolist()))
    return out


def _shard_slots(key, b_local, negative, n_slots, neg_group=0):
    """JAX's per-shard negative slots for one sharded SGNS step."""
    rows = b_local // neg_group if neg_group else b_local
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, s),
                                          (rows, negative), 0, n_slots))
            for s in range(WORLD)]


def _step_inputs():
    rng = np.random.RandomState(0)
    syn0 = ((rng.rand(V, D) - 0.5) / D).astype(np.float32)
    syn1 = (rng.randn(V, D) * 0.1).astype(np.float32)
    probs = rng.rand(V) ** 0.75
    neg_table = np.searchsorted(np.cumsum(probs / probs.sum()),
                                (np.arange(SLOTS) + 0.5) / SLOTS)
    centers = rng.randint(0, V, BG).astype(np.int32)
    contexts = rng.randint(0, V, BG).astype(np.int32)
    weights = np.ones(BG, np.float32)
    common = {"kind": "w2v_step", "syn0": syn0, "syn1": syn1, "lr": LR,
              "centers": centers, "contexts": contexts, "weights": weights,
              "neg_table": neg_table.astype(np.int64), "negative": NEG,
              "key": KEY}
    jkey = jax.random.PRNGKey(KEY)
    out = {}
    for name, groups in (("sgns", 0), ("sgns_shared", 4)):
        out[name] = dict(common, objective="sgns", neg_group=groups,
                         slots=[[s] for s in _shard_slots(
                             jkey, BG // WORLD, NEG, SLOTS, groups)])
    # HS with a padded tail: weight 0, center and context 0, as the fit
    # pads; per-word paths of random lengths over the V-1 inner nodes
    lens = rng.randint(1, LMAX + 1, V)
    pts = rng.randint(0, V - 1, (V, LMAX)).astype(np.int32)
    cds = rng.randint(0, 2, (V, LMAX)).astype(np.float32)
    msk = (np.arange(LMAX)[None, :] < lens[:, None]).astype(np.float32)
    hc, ht, hw = centers.copy(), contexts.copy(), weights.copy()
    hc[-N_PAD:] = ht[-N_PAD:] = 0
    hw[-N_PAD:] = 0.0
    out["hs"] = dict(common, objective="hs", syn1=syn1[:V - 1].copy(),
                     centers=hc, contexts=ht, weights=hw, points=pts[ht],
                     codes=cds[ht], mask=msk[ht])
    return out


def _jax_step(inp):
    mesh = jmesh.data_parallel_mesh(WORLD)
    a = {k: jnp.asarray(inp[k]) for k in ("syn0", "syn1", "centers",
                                          "weights")}
    if inp["objective"] == "hs":
        step = jw2v.make_sharded_hs_step(mesh)
        out = step(a["syn0"], a["syn1"], a["centers"],
                   jnp.asarray(inp["points"]), jnp.asarray(inp["codes"]),
                   jnp.asarray(inp["mask"]), a["weights"], jnp.float32(LR))
    else:
        step = jw2v.make_sharded_sgns_step(mesh, NEG, inp["neg_group"])
        out = step(a["syn0"], a["syn1"], a["centers"],
                   jnp.asarray(inp["contexts"]), a["weights"],
                   jnp.asarray(inp["neg_table"].astype(np.int32)),
                   jnp.float32(LR), jax.random.PRNGKey(KEY))
    return [np.asarray(x) for x in out]


def _jax_fit():
    vec = jw2v.Word2Vec(sentence_iterator=JSentences(_corpus()),
                        tokenizer_factory=PythonTokenizer(),
                        mesh=jmesh.data_parallel_mesh(WORLD), **FIT_KW)
    vec.fit()
    # the negatives JAX drew: a key split a step, folded per shard
    b_local = vec.batch_size // WORLD
    ng = jw2v.neg_group_size(b_local, FIT_KW["shared_negatives"])
    key = jax.random.PRNGKey(FIT_KW["seed"])
    slots = [[] for _ in range(WORLD)]
    for _ in range(vec.last_fit_timings["n_dispatches"]):
        key, sub = jax.random.split(key)
        for s, a in enumerate(_shard_slots(sub, b_local, NEG, 1 << 20,
                                           ng)):
            slots[s].append(a)
    table = vec.lookup_table
    return vec, slots, {"syn0": np.asarray(table.syn0),
                        "syn1": np.asarray(table.syn1),
                        "syn1neg": np.asarray(table.syn1neg)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("w2v_mesh")
    inputs = _step_inputs()
    jvec, fit_slots, fit_ref = _jax_fit()
    inputs["fit"] = {"kind": "w2v_fit", "corpus": _corpus(),
                     "kwargs": FIT_KW, "slots": fit_slots}
    procs = spawn_ranks(root, inputs, WORLD)
    try:
        ref = {name: _jax_step(inp) for name, inp in inputs.items()
               if inp["kind"] == "w2v_step"}
    finally:
        results = collect_ranks(root, procs, SPAWN_TIMEOUT_S)
    ref["fit"] = fit_ref
    ref["fit_vec"] = jvec
    return inputs, results, ref


def _rank(runs, name, rank=0):
    out = runs[1][rank][name]
    assert "error" not in out, out.get("error")
    return out


def _close(got, want, tol):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    assert err <= tol, err


@pytest.mark.parametrize("name", ["sgns", "sgns_shared", "hs"])
def test_sharded_step_matches_jax_on_every_rank(runs, name):
    syn0, syn1, loss = runs[2][name]
    for rank in range(WORLD):
        out = _rank(runs, name, rank)
        _close(out["syn0"], syn0, STEP_TOL * np.abs(syn0).max())
        _close(out["syn1"], syn1, STEP_TOL * np.abs(syn1).max())
        np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)


def test_padded_hs_tail_counts_padded_rows_as_jax_does(runs):
    """JAX's sharded HS step adds the path mask alone to syn1's collision
    counts, where ``_hs_update`` weights it by the pair weight. The port
    copies the step as it is: both differ from ``_hs_update`` exactly on
    the padded context's path nodes, by ``N_PAD`` in each node's count."""
    inp = runs[0]["hs"]
    syn0_j, syn1_j, _ = runs[2]["hs"]
    got = _rank(runs, "hs", 2)
    t = {k: torch.from_numpy(np.array(inp[k])) for k in
         ("syn0", "syn1", "centers", "points", "codes", "mask", "weights")}
    s0, s1, _ = tw2v._hs_update(t["syn0"], t["syn1"], t["centers"].long(),
                                t["points"].long(), t["codes"], t["mask"],
                                t["weights"], LR)
    s0, s1 = s0.numpy(), s1.numpy()
    _close(got["syn0"], s0, STEP_TOL * np.abs(s0).max())
    path0 = inp["points"][-1][inp["mask"][-1] > 0]          # word 0's nodes
    on_path = np.zeros(V - 1, bool)
    on_path[path0] = True
    real = inp["weights"] > 0
    cnt = np.zeros(V - 1)
    np.add.at(cnt, inp["points"][real].reshape(-1),
              inp["mask"][real].reshape(-1))
    diff = np.abs(got["syn1"] - s1).max(1)
    touched = on_path & (cnt > 0)     # nodes a real pair updates
    assert touched.any() and (diff[touched] > 0).all()
    tol = STEP_TOL * np.abs(s1).max()
    assert (diff[~on_path] <= tol).all()
    # the same -lr·g over a count larger by N_PAD on word 0's nodes
    d_single = (s1 - inp["syn1"])[on_path]
    for d_mesh in (got["syn1"] - inp["syn1"], syn1_j - inp["syn1"]):
        lhs = d_mesh[on_path] * np.maximum(cnt[on_path] + N_PAD, 1)[:, None]
        rhs = d_single * np.maximum(cnt[on_path], 1)[:, None]
        np.testing.assert_allclose(lhs, rhs, atol=1e-6)


def test_mesh_fit_matches_jax_on_every_rank(runs):
    ref, jvec = runs[2]["fit"], runs[2]["fit_vec"]
    for rank in range(WORLD):
        out = _rank(runs, "fit", rank)
        assert out["batch_size"] == jvec.batch_size == 252
        assert out["n_pairs"] == jvec.last_fit_timings["n_pairs"]
        assert out["n_dispatches"] == jvec.last_fit_timings["n_dispatches"]
        for k in ("syn0", "syn1", "syn1neg"):
            _close(out[k], ref[k], EPOCH_TOL)
    # it trained: the tables moved off their initial values
    assert np.abs(ref["syn1neg"]).max() > 0


@pytest.mark.parametrize("n,batch", [(3, 2048), (4, 2048), (8, 1001)])
def test_batch_rounds_up_to_the_data_axis(n, batch):
    jvec = jw2v.Word2Vec(batch_size=batch, mesh=jmesh.data_parallel_mesh(n))
    fake = types.SimpleNamespace(axis_names=("data",), shape={"data": n},
                                 coords={"data": 0}, device=None, size=n)
    tvec = tw2v.Word2Vec(batch_size=batch, mesh=fake, device="cpu")
    assert tvec.batch_size == jvec.batch_size
    assert tvec.batch_size % n == 0 and tvec.batch_size - batch < n
