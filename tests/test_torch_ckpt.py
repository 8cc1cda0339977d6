"""The port's checkpoint format (deeplearning4j_tpu_torch/scaleout/ckpt)
held against the JAX package's, on the CPU.

A checkpoint crosses both ways bit for bit: the JAX package's saves (f32,
bf16, and sharded over the tests' 8-device CPU mesh) restore in the port,
and the port's saves carry the JAX package's manifest (paths, order,
shapes, dtypes, chunks, CRCs) and its npz members byte for byte. Every
comparison here is exact (tolerance 0).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deeplearning4j_tpu.models.transformer_lm import (
    init_lm_params as j_init_lm_params,
    lm_checkpoint_meta as j_lm_checkpoint_meta,
)
from deeplearning4j_tpu.scaleout.ckpt import manifest as jmf
from deeplearning4j_tpu.scaleout.ckpt import reshard as jrs
from deeplearning4j_tpu.scaleout.ckpt.checkpointer import (
    Checkpointer as JCheckpointer,
)
from deeplearning4j_tpu.telemetry.registry import (
    MetricsRegistry as JRegistry,
)
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.scaleout.ckpt import (
    Checkpointer,
    CorruptShardError,
    latest_step,
    merge_process_manifests,
    read_manifest,
    restore_sharded,
    save_process_shards,
    template_from_manifest,
    verify_checksums,
)
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent
V, D, H, E, DFF, L = 64, 16, 2, 4, 32, 2


@pytest.fixture(scope="module")
def jparams():
    return j_init_lm_params(jax.random.PRNGKey(3), V, D, H, E, DFF,
                            n_layers=L)


def _jax_tree(jparams, dtype):
    if dtype == "bfloat16":
        return jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                      jparams)
    return jparams


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array (tensor or JAX array)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _assert_same_tree(port_tree, jax_tree):
    jleaves = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    pleaves = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"[{k!r}]")
        else:
            pleaves[path] = node

    walk(port_tree, "")
    assert sorted(pleaves) == sorted(jax.tree_util.keystr(p)
                                     for p, _ in jleaves)
    for path, leaf in jleaves:
        got = pleaves[jax.tree_util.keystr(path)]
        assert tuple(got.shape) == tuple(leaf.shape)
        assert str(got.dtype).replace("torch.", "") == str(leaf.dtype)
        np.testing.assert_array_equal(_bits(got), _bits(leaf))


def _mesh_sharded(jparams):
    """The params placed on a (dp=2, ep=4) mesh of the 8 CPU devices:
    experts split over ``ep``, the embedding over ``dp``, the rest
    replicated — several chunks per leaf in several shard files."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dp", "ep"))

    def spec(path, _):
        keys = [p.key for p in path]
        if "experts" in keys:
            return NamedSharding(mesh, P(None, "ep"))
        if keys == ["embed"]:
            return NamedSharding(mesh, P("dp", None))
        return NamedSharding(mesh, P())

    shardings = jax.tree_util.tree_map_with_path(spec, jparams)
    return jax.tree_util.tree_map(jax.device_put, jparams, shardings)


@pytest.mark.parametrize("case", ["f32", "bf16", "sharded"])
def test_jax_save_restores_in_port_bitwise(jparams, tmp_path, case):
    tree = {"f32": jparams, "sharded": _mesh_sharded(jparams),
            "bf16": _jax_tree(jparams, "bfloat16")}[case]
    root = str(tmp_path / "ckpt")
    JCheckpointer(root, registry=JRegistry()).save(
        4, {"params": tree}, meta=j_lm_checkpoint_meta(jparams, H))
    manifest = read_manifest(os.path.join(root, "step_0000000004"))
    if case == "sharded":
        w1 = manifest.leaf("['params']['blocks']['experts']['w1']")
        assert len(w1.chunks) == 4
        assert len(manifest.leaf("['params']['embed']").chunks) == 2
        assert len(manifest.files) > 1
    template = template_from_manifest(manifest)
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(
                   template, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    state, step, meta = Checkpointer(root, registry=MetricsRegistry()) \
        .restore(template, device="cpu")
    assert step == 4 and meta["lm"]["n_heads"] == H
    _assert_same_tree(state["params"], tree)


def _manifest_dict(step_dir):
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        return json.load(f)


def _members(step_dir):
    with zipfile.ZipFile(os.path.join(step_dir, "shard_00000.npz")) as z:
        return [(n, z.read(n)) for n in z.namelist()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_save_matches_jax_save_and_restores_in_jax(jparams, tmp_path,
                                                         dtype):
    jtree = _jax_tree(jparams, dtype)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    ptree = lm_params_from_numpy(np_tree, device="cpu",
                                 dtype=getattr(torch, dtype))
    meta = j_lm_checkpoint_meta(jparams, H)
    jdir = JCheckpointer(str(tmp_path / "j"), registry=JRegistry()).save(
        9, {"params": jtree}, meta=meta)
    pdir = Checkpointer(str(tmp_path / "p"), registry=MetricsRegistry()) \
        .save(9, {"params": ptree}, meta=meta)
    # the same manifest: paths, order, shapes, dtypes, chunks, CRCs, meta
    assert _manifest_dict(pdir) == _manifest_dict(jdir)
    # and the same npz members, header and data, byte for byte
    assert _members(pdir) == _members(jdir)
    assert jrs.verify_checksums(pdir) == []
    if dtype == "float32":
        jman = jmf.read_manifest(pdir)
        state, step, jmeta = JCheckpointer(
            str(tmp_path / "p"), registry=JRegistry()).restore(
            jrs.template_from_manifest(jman))
        assert step == 9 and jmeta == meta
        _assert_same_tree(ptree, state["params"])
    else:
        # JAX's Checkpointer.restore cannot read a bf16 leaf back, its own
        # saves included: numpy has no cast from the stored void records
        # to ml_dtypes.bfloat16 ("No cast function available", ROADMAP
        # Queue 3); so JAX's chunk reader takes the port's bytes, checks
        # their CRCs and views them as bfloat16
        jman = jmf.read_manifest(pdir)
        with jrs._ChunkStore(pdir, verify_crc=True) as store:
            for entry, (path, leaf) in zip(
                    jman.leaves,
                    jax.tree_util.tree_flatten_with_path(
                        {"params": jtree})[0]):
                assert entry.path == jax.tree_util.keystr(path)
                got = store.get_checked(entry, 0).view(ml_dtypes.bfloat16)
                np.testing.assert_array_equal(_bits(got), _bits(leaf))


def test_port_round_trip_of_mixed_trees(tmp_path):
    """Tuples, lists, None, numpy and integer leaves, and a dtype widened
    on restore (int32 into int64, bf16 into f32: both lossless)."""
    rng = np.random.default_rng(0)
    tree = {"b": (torch.arange(5, dtype=torch.int32),
                  [torch.tensor(rng.standard_normal((2, 3)),
                                dtype=torch.bfloat16), None]),
            "a": rng.standard_normal(4).astype(np.float32)}
    ck = Checkpointer(str(tmp_path), registry=MetricsRegistry())
    step_dir = ck.save(1, tree)
    assert [e.path for e in read_manifest(step_dir).leaves] == \
        ["['a']", "['b'][0]", "['b'][1][0]"]
    state, _, _ = ck.restore(tree, device="cpu")
    assert torch.equal(state["b"][0], tree["b"][0])
    assert torch.equal(state["b"][1][0], tree["b"][1][0])
    assert state["b"][1][1] is None
    np.testing.assert_array_equal(state["a"].numpy(), tree["a"])
    wide = {"b": (torch.zeros(5, dtype=torch.int64),
                  [torch.zeros((2, 3)), None]), "a": np.zeros(4, np.float64)}
    state, _, _ = ck.restore(wide, device="cpu")
    assert state["b"][0].dtype == torch.int64
    assert torch.equal(state["b"][1][0], tree["b"][1][0].float())


def test_restore_is_strict_like_jax(jparams, tmp_path):
    root = str(tmp_path)
    ck = Checkpointer(root, registry=MetricsRegistry())
    ptree = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    ck.save(1, ptree)
    template = template_from_manifest(read_manifest(
        os.path.join(root, "step_0000000001")))
    bad = dict(template, embed=torch.empty((V + 1, D), device="meta"))
    with pytest.raises(ValueError, match="refusing to broadcast"):
        ck.restore(bad, device="cpu")
    narrow = dict(template, embed=torch.empty((V, D), dtype=torch.float16,
                                              device="meta"))
    with pytest.raises(TypeError, match="lossy dtype narrowing"):
        ck.restore(narrow, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(dict(template, extra=torch.empty(1, device="meta")),
                   device="cpu")
    # a restore into specs needs the rank's place on their mesh, a save
    # with specs the mesh they name; a merge waits for every part
    with pytest.raises(ValueError, match="needs mesh="):
        ck.restore(template, shardings={"embed": (None, "model")},
                   device="cpu")
    with pytest.raises(ValueError, match="needs the mesh"):
        ck.save(2, ptree, specs={"embed": ()})
    save_process_shards(root, 2, ptree)
    with pytest.raises(TimeoutError, match="1/2 part manifests"):
        merge_process_manifests(root, 2, 2, timeout_s=0.2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.restore(template)


def test_manifest_less_dirs_are_invisible(jparams, tmp_path):
    root = str(tmp_path)
    Checkpointer(root, registry=MetricsRegistry()).save(
        3, {"w": torch.ones(2)})
    os.makedirs(os.path.join(root, "step_0000000007"))  # interrupted save
    assert latest_step(root) == jrs.latest_step(root) == 3
    assert Checkpointer(root).latest_step() == 3
    ck = Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.empty(2, device="meta")}, device="cpu")


def test_flipped_byte_raises_corrupt_shard_error(jparams, tmp_path):
    root = str(tmp_path)
    step_dir = JCheckpointer(root, registry=JRegistry()).save(
        2, {"params": jparams})
    shard = os.path.join(step_dir, "shard_00000.npz")
    # one byte of dec_b flipped, the npz rewritten whole (valid as a zip:
    # only the manifest's CRC can tell)
    with np.load(shard) as z:
        payload = {k: np.array(z[k]) for k in z.files}
    payload["['params']['dec_b']"].view(np.uint8)[-1] ^= 0xFF
    with open(shard, "wb") as f:
        np.savez(f, **payload)
    problems = verify_checksums(step_dir)
    assert problems == jrs.verify_checksums(step_dir)
    assert len(problems) == 1 and "['params']['dec_b']" in problems[0]
    template = template_from_manifest(read_manifest(step_dir))
    with pytest.raises(CorruptShardError, match="shard_00000.npz is corrupt"):
        Checkpointer(root).restore(template, device="cpu")
    with pytest.raises(ValueError, match="failed checksum verification"):
        Checkpointer(root, verify_on_restore=True).restore(template,
                                                           device="cpu")
    state, _ = restore_sharded(step_dir, template, verify_crc=False,
                               device="cpu")
    assert state["params"]["dec_b"].shape == (V,)


def _retention_run(ck, save, tmp_root):
    for step in (1, 2, 3):
        save(ck, step)
    ck.mark_last_good(2)
    os.makedirs(os.path.join(tmp_root, "step_0000000004"))  # interrupted
    for step in (5, 6):
        save(ck, step)
    return [s for s, _ in ck.step_dirs()], sorted(os.listdir(tmp_root))


def test_retention_keep_last_gc_and_last_good_match_jax(tmp_path):
    reg = MetricsRegistry()
    port = _retention_run(
        Checkpointer(str(tmp_path / "p"), keep_last=2, registry=reg),
        lambda ck, s: ck.save(s, {"w": torch.full((3,), float(s))}),
        str(tmp_path / "p"))
    jreg = JRegistry()
    jax_run = _retention_run(
        JCheckpointer(str(tmp_path / "j"), keep_last=2, registry=jreg),
        lambda ck, s: ck.save(s, {"w": jnp.full((3,), float(s))}),
        str(tmp_path / "j"))
    assert port == jax_run
    assert port[0] == [2, 5, 6]  # step 2 is tagged last-good; 4 swept
    assert Checkpointer(str(tmp_path / "p")).last_good_step() == 2
    for name in ("ckpt_saves_total", "ckpt_bytes_total"):
        assert reg.counter(name).value == jreg.counter(name).value
    for name in ("ckpt_last_step", "ckpt_last_bytes", "ckpt_last_shards",
                 "ckpt_last_good_step"):
        assert reg.gauge(name).value == jreg.gauge(name).value
    assert reg.histogram("ckpt_save_ms").count == 5
    ck = Checkpointer(str(tmp_path / "p"), registry=reg)
    ck.restore({"w": torch.empty(3, device="meta")}, step=5, device="cpu")
    assert reg.counter("ckpt_restores_total").value == 1
    assert reg.histogram("ckpt_restore_ms").count == 1
    # the restored step is pinned against the next sweep
    ck.keep_last = 1
    ck.save(7, {"w": torch.zeros(3)})
    assert [s for s, _ in ck.step_dirs()] == [2, 5, 7]
    assert ck.maybe_save(8, lambda: {"w": torch.zeros(3)}, 3) is None
    assert ck.maybe_save(9, lambda: {"w": torch.zeros(3)}, 3) is not None


def test_bf16_restore_needs_no_ml_dtypes(jparams, tmp_path):
    """In a subprocess with ``ml_dtypes`` blocked, as on a host without
    JAX: the port restores a JAX bf16 checkpoint to the same bits."""
    root = str(tmp_path / "ckpt")
    jtree = _jax_tree(jparams, "bfloat16")
    JCheckpointer(root, registry=JRegistry()).save(
        1, {"params": jtree}, meta=j_lm_checkpoint_meta(jparams, H))
    out = str(tmp_path / "bits.npz")
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch\n"
        "from deeplearning4j_tpu_torch.scaleout.ckpt import Checkpointer, "
        "read_manifest, template_from_manifest, latest_step_dir\n"
        f"root = {root!r}\n"
        "t = template_from_manifest(read_manifest(latest_step_dir(root)))\n"
        "s, _, _ = Checkpointer(root).restore(t, device='cpu')\n"
        "flat = {}\n"
        "def walk(n, p):\n"
        "    if isinstance(n, dict):\n"
        "        [walk(v, p + '/' + k) for k, v in n.items()]\n"
        "    else:\n"
        "        assert n.dtype == torch.bfloat16, n.dtype\n"
        "        flat[p] = n.view(torch.int16).numpy()\n"
        "walk(s, '')\n"
        f"np.savez({out!r}, **flat)\n"
        "assert sys.modules['ml_dtypes'] is None\n"
        "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"params": jtree})[0]:
        want["/" + "/".join(p.key for p in path)] = leaf
    assert sorted(got) == sorted(want)
    for k, leaf in want.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(leaf))
