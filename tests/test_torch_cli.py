"""The port's CLI (deeplearning4j_tpu_torch/cli/driver.py) held against the
JAX package's, on the CPU.

Every test of tests/test_cli.py runs here through the port's ``main`` with
``--device cpu``. On top of that, the two CLIs are run side by side on the
same files: LM ``predict`` rows from one checkpoint (greedy, f32: token
for token), ``predict``/``test`` of a JAX-trained ``params.npz`` (the same
classes and the same ``Evaluation.stats()`` text), and ``train`` from the
JAX net's initial params (the port's params within
tests/test_torch_multilayer.py's ATOL of the JAX CLI's).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.cli.driver import main as jmain
from deeplearning4j_tpu.models.transformer_lm import (
    init_lm_params as j_init_lm_params,
    lm_checkpoint_meta as j_lm_checkpoint_meta,
)
from deeplearning4j_tpu.nn.conf import (
    MultiLayerConfiguration as JConfiguration,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.scaleout.ckpt.checkpointer import (
    Checkpointer as JCheckpointer,
)
from deeplearning4j_tpu.telemetry.registry import (
    MetricsRegistry as JRegistry,
)
from deeplearning4j_tpu_torch.cli import driver
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
# tests/test_torch_multilayer.py's tolerance for f32 training parity
ATOL = 1e-5


def main(argv):
    return driver.main(list(argv) + CPU)


def _conf(ada_grad=True):
    return (
        NeuralNetConfiguration.Builder()
        .n_in(4).n_out(8).activation_function("tanh").lr(0.1)
        .momentum(0.9).use_ada_grad(ada_grad).num_iterations(60).seed(42)
        .weight_init("VI").list(2)
        .override(0, layer_type="DENSE")
        .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                  activation_function="softmax", loss_function="MCXENT")
        .pretrain(False).backward(True).build()
    )


@pytest.fixture
def conf_path(tmp_path):
    p = tmp_path / "model.json"
    p.write_text(_conf().to_json())
    return str(p)


@pytest.fixture
def iris_csv(tmp_path):
    from deeplearning4j_tpu_torch.datasets.fetchers import iris_data

    x, y = iris_data()  # y: (150,) integer classes
    lines = [",".join(f"{v:.4f}" for v in row) + f",{int(lab)}"
             for row, lab in zip(x, y)]
    p = tmp_path / "iris.csv"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


# ------------------------------------------- tests/test_cli.py, mirrored ----

def test_train_test_predict_round_trip(tmp_path, conf_path, iris_csv, capsys):
    model = str(tmp_path / "params.npz")
    assert main(["train", "--conf", conf_path, "--input", iris_csv,
                 "--model", model, "--labels", "3", "--batch", "150"]) == 0
    assert np.load(model)["params"].ndim == 1

    assert main(["test", "--conf", conf_path, "--input", iris_csv,
                 "--model", model, "--labels", "3", "--batch", "150"]) == 0
    out = capsys.readouterr().out
    assert "Accuracy" in out

    pred_file = str(tmp_path / "preds.txt")
    assert main(["predict", "--conf", conf_path, "--input", iris_csv,
                 "--model", model, "--labels", "3", "--batch", "150",
                 "--output", pred_file]) == 0
    preds = [int(l) for l in open(pred_file).read().split()]
    assert len(preds) == 150
    assert set(preds) <= {0, 1, 2}
    # trained model beats chance comfortably
    from deeplearning4j_tpu_torch.datasets.fetchers import iris_data

    _, y = iris_data()
    acc = np.mean(np.asarray(preds) == y)
    assert acc > 0.8, acc


def test_predict_to_stdout(tmp_path, conf_path, iris_csv, capsys):
    model = str(tmp_path / "params.npz")
    main(["train", "--conf", conf_path, "--input", iris_csv,
          "--model", model, "--labels", "3", "--batch", "150"])
    main(["predict", "--conf", conf_path, "--input", iris_csv,
          "--model", model, "--labels", "3", "--batch", "150"])
    out = capsys.readouterr().out.split()
    assert len(out) == 150


def test_svmlight_requires_features(conf_path, tmp_path):
    svm = tmp_path / "d.svm"
    svm.write_text("0 1:1.0\n")
    with pytest.raises(SystemExit):
        main(["train", "--conf", conf_path, "--input", str(svm),
              "--model", str(tmp_path / "m.npz"), "--labels", "3"])


def test_missing_subcommand_errors():
    with pytest.raises(SystemExit):
        driver.main([])


def test_mem_uri_model_round_trip(conf_path, iris_csv, capsys):
    """mem:// models persist for the process, and a key directly after the
    scheme must not create a literal local 'mem:' directory."""
    for uri in ("mem://models/iris-params", "mem://iris-params.npz"):
        rc = main(["train", "--conf", str(conf_path), "--input",
                   str(iris_csv), "--model", uri, "--labels", "3",
                   "--epochs", "2"])
        assert rc == 0
        rc = main(["test", "--conf", str(conf_path), "--input",
                   str(iris_csv), "--model", uri, "--labels", "3"])
        assert rc == 0
        assert "Accuracy" in capsys.readouterr().out
    assert not os.path.exists("mem:")


def _lm_checkpoint(tmp_path, n_layers=2, step=7):
    params = j_init_lm_params(jax.random.PRNGKey(0), 31, 8, 2, 2, 16,
                              n_layers=n_layers)
    root = str(tmp_path / "lm_ckpt")
    JCheckpointer(root, registry=JRegistry()).save(
        step, {"params": params}, meta=j_lm_checkpoint_meta(params, 2))
    return root


def test_predict_lm_checkpoint_generates_through_decode_engine(tmp_path,
                                                               capsys):
    """``predict --model <ckpt_dir>`` routes LM checkpoints through the
    KV-cached decode engine (no --conf needed) and the output matches a
    direct engine run with the same knobs."""
    from deeplearning4j_tpu_torch.serve import DecodeEngine

    root = _lm_checkpoint(tmp_path)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("1 2 3 4\n10, 20, 30\n\n5 6\n")
    out_path = str(tmp_path / "gen.txt")
    rc = main(["predict", "--model", root, "--input", str(prompts),
               "--output", out_path, "--max-new-tokens", "4",
               "--serve-dtype", "f32"])
    assert rc == 0
    rows = [[int(t) for t in line.split()]
            for line in open(out_path).read().strip().splitlines()]
    assert len(rows) == 3  # blank prompt lines are skipped
    assert all(len(r) == 4 for r in rows)

    eng = DecodeEngine.from_checkpoint(root, serve_dtype="f32", device="cpu")
    want = [eng.generate(p, max_new_tokens=4)
            for p in ([1, 2, 3, 4], [10, 20, 30], [5, 6])]
    assert rows == want

    # stdout path + verbose engine stats line
    rc = main(["predict", "--model", root, "--input", str(prompts),
               "--max-new-tokens", "2", "--serve-dtype", "f32",
               "--verbose"])
    assert rc == 0
    out = capsys.readouterr().out
    assert len(out.strip().splitlines()) == 3 + 1  # 3 rows + stats line
    assert "decode engine:" in out


def test_predict_lm_rejects_bad_prompt_file(tmp_path):
    root = _lm_checkpoint(tmp_path, n_layers=1, step=1)
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 three\n")
    with pytest.raises(SystemExit, match="token ids"):
        main(["predict", "--model", root, "--input", str(bad)])
    empty = tmp_path / "empty.txt"
    empty.write_text("\n\n")
    with pytest.raises(SystemExit, match="no prompts"):
        main(["predict", "--model", root, "--input", str(empty)])


def test_predict_without_conf_on_non_lm_model_errors(tmp_path, iris_csv):
    with pytest.raises(SystemExit, match="--conf is required"):
        main(["predict", "--model", str(tmp_path / "nope.npz"),
              "--input", iris_csv])


def test_split_store_uri():
    from deeplearning4j_tpu_torch.scaleout.blobstore import split_store_uri

    assert split_store_uri("mem://a/b/key.npz") == ("mem://a/b", "key.npz")
    assert split_store_uri("mem://key.npz") == ("mem://", "key.npz")
    assert split_store_uri("file:///d/key.npz") == ("file:///d", "key.npz")
    # root-level keys keep the leading '/' (never CWD-relative)
    assert split_store_uri("file:///key.npz") == ("file:///", "key.npz")
    assert split_store_uri("/key.npz") == ("/", "key.npz")
    assert split_store_uri("/d/key.npz") == ("/d", "key.npz")


# ------------------------------------------- the two CLIs side by side ----

def test_predict_lm_rows_equal_the_jax_cli(tmp_path):
    root = _lm_checkpoint(tmp_path)
    rng = np.random.RandomState(5)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(
        " ".join(map(str, rng.randint(0, 31, rng.randint(1, 20))))
        for _ in range(7)) + "\n")
    args = ["predict", "--model", root, "--input", str(prompts),
            "--max-new-tokens", "5", "--serve-dtype", "f32", "--slots", "3",
            "--max-len", "64"]
    assert jmain(args + ["--output", str(tmp_path / "jax.txt")]) == 0
    assert main(args + ["--output", str(tmp_path / "port.txt")]) == 0
    port = (tmp_path / "port.txt").read_text()
    assert port == (tmp_path / "jax.txt").read_text()
    assert len(port.strip().splitlines()) == 7


def test_jax_trained_params_give_identical_predict_and_stats(
        tmp_path, conf_path, iris_csv, capsys):
    model = str(tmp_path / "jax_params")  # extension-less, as users pass it
    assert jmain(["train", "--conf", conf_path, "--input", iris_csv,
                  "--model", model, "--labels", "3", "--batch", "50"]) == 0
    outs = {}
    for name, run in (("jax", jmain), ("port", main)):
        assert run(["predict", "--conf", conf_path, "--input", iris_csv,
                    "--model", model, "--labels", "3", "--batch", "64",
                    "--output", str(tmp_path / f"{name}.txt")]) == 0
        capsys.readouterr()
        assert run(["test", "--conf", conf_path, "--input", iris_csv,
                    "--model", model, "--labels", "3", "--batch", "64"]) == 0
        outs[name] = capsys.readouterr().out
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    assert outs["port"] == outs["jax"]
    assert "Accuracy" in outs["port"]


@pytest.mark.parametrize("ada_grad", [True, False])
def test_train_from_the_jax_init_matches_the_jax_cli(tmp_path, iris_csv,
                                                     monkeypatch, ada_grad):
    """Threefry and Philox never agree, so the port's net starts from the
    JAX net's initial params (``_load_model`` patched to inject them);
    after one epoch of 3 batches, 60 iterations each (180 steps at lr 0.1),
    the saved params of the two CLIs agree within ATOL (measured: at most
    4.8e-6 on params up to 5). The two sum in other orders, so the gap
    grows with the run: twice as many steps reached 2.5e-5 on params up to
    11, 4e-6 of their scale."""
    conf = _conf(ada_grad)
    conf_path = tmp_path / "model.json"
    conf_path.write_text(conf.to_json())
    init = np.array(JNet(JConfiguration.from_json(conf.to_json()))
                      .init().params())
    load = driver._load_model

    def from_jax_init(path, params_path, device):
        net = load(path, params_path, device)
        if params_path is None:
            net.set_params(init)
        return net

    monkeypatch.setattr(driver, "_load_model", from_jax_init)
    args = ["train", "--conf", str(conf_path), "--input", iris_csv,
            "--labels", "3", "--batch", "50"]
    assert jmain(args + ["--model", str(tmp_path / "jax.npz")]) == 0
    assert main(args + ["--model", str(tmp_path / "port.npz")]) == 0
    want = np.load(tmp_path / "jax.npz")["params"]
    got = np.load(tmp_path / "port.npz")["params"]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert not np.allclose(want, init)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _regression_files(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    y = x @ np.array([0.5, -1.0, 2.0], np.float32) + 0.1
    csv = tmp_path / "reg.csv"
    csv.write_text("\n".join(",".join(f"{v:.5f}" for v in (*r, t))
                             for r, t in zip(x, y)) + "\n")
    conf = (NeuralNetConfiguration.Builder()
            .n_in(3).n_out(1).lr(0.05).num_iterations(20).seed(7)
            .list(1)
            .override(0, layer_type="OUTPUT", n_in=3, n_out=1,
                      activation_function="linear", loss_function="MSE")
            .pretrain(False).backward(True).build())
    conf_path = tmp_path / "reg.json"
    conf_path.write_text(conf.to_json())
    return str(csv), str(conf_path)


def test_regression_test_and_predict_match_the_jax_cli(tmp_path, capsys):
    """No --labels: ``test`` reports MSE/MAE and ``predict`` writes raw
    outputs, from a JAX-trained model, as the JAX CLI does."""
    csv, conf = _regression_files(tmp_path)
    model = str(tmp_path / "reg.npz")
    assert jmain(["train", "--conf", conf, "--input", csv, "--model", model,
                  "--batch", "16"]) == 0
    got = {}
    for name, run in (("jax", jmain), ("port", main)):
        capsys.readouterr()
        assert run(["test", "--conf", conf, "--input", csv, "--model", model,
                    "--batch", "16"]) == 0
        text = capsys.readouterr().out
        assert text.startswith("MSE: ") and "\nMAE: " in text
        metrics = [float(line.split()[1]) for line in text.splitlines()]
        assert run(["predict", "--conf", conf, "--input", csv, "--model",
                    model, "--batch", "16", "--output",
                    str(tmp_path / f"{name}.txt")]) == 0
        rows = np.loadtxt(tmp_path / f"{name}.txt", delimiter=",")
        got[name] = (metrics, rows)
    assert got["port"][1].shape == (40,)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(got["port"][1], got["jax"][1], atol=2e-6,
                               rtol=0)


def test_svmlight_train_and_test_match_the_jax_cli(tmp_path, iris_csv,
                                                   capsys):
    from deeplearning4j_tpu_torch.datasets.fetchers import iris_data

    x, y = iris_data()
    svm = tmp_path / "iris.svm"
    svm.write_text("".join(
        f"{int(l)} " + " ".join(f"{i + 1}:{v:.4f}" for i, v in enumerate(r)
                                 if abs(v) > 0.5) + "\n"
        for r, l in zip(x, y)))
    conf = tmp_path / "model.json"
    conf.write_text(_conf(ada_grad=False).to_json())
    model = str(tmp_path / "svm.npz")
    common = ["--conf", str(conf), "--input", str(svm), "--labels", "3",
              "--features", "4", "--batch", "64"]
    assert jmain(["train", "--model", model, *common]) == 0
    outs = {}
    for name, run in (("jax", jmain), ("port", main)):
        capsys.readouterr()
        assert run(["test", "--model", model, *common]) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert main(["train", "--model", str(tmp_path / "p.npz"), *common]) == 0


def test_device_cuda_is_the_default_and_raises_without_cuda(conf_path,
                                                            iris_csv,
                                                            tmp_path):
    args = driver.build_parser().parse_args(
        ["train", "--conf", conf_path, "--input", iris_csv, "--model", "m"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            driver.main(["train", "--conf", conf_path, "--input", iris_csv,
                         "--model", str(tmp_path / "m.npz"), "--labels",
                         "3"])


@pytest.mark.parametrize("extra,slice_", [
    (["--runtime", "parallel"], "slice 7"),
    (["--profile", "trace_dir"], "slice 9"),
])
def test_unported_train_options_exit_naming_their_slice(conf_path, iris_csv,
                                                        tmp_path, extra,
                                                        slice_, monkeypatch):
    """``--profile`` exits naming slice 9. ``--runtime parallel``, which
    slice 7 brought, now trains through the port's
    ParameterAveragingTrainer on a one-rank mesh: from the JAX net's
    initial params it saves the params of JAX's trainer on
    ``data_parallel_mesh(1)`` (the JAX CLI's, with its mesh cut to one
    device) within ATOL, after 3 batches of 60 local iterations."""
    args = ["train", "--conf", conf_path, "--input", iris_csv, "--labels",
            "3", *extra]
    if extra[:2] != ["--runtime", "parallel"]:
        with pytest.raises(SystemExit, match=slice_):
            main(args + ["--model", str(tmp_path / "m.npz")])
        assert not (tmp_path / "m.npz").exists()
        return
    from deeplearning4j_tpu.parallel import mesh as jmesh

    init = np.array(JNet(JConfiguration.from_json(_conf().to_json()))
                    .init().params())
    load, one_device = driver._load_model, jmesh.data_parallel_mesh

    def from_jax_init(path, params_path, device):
        net = load(path, params_path, device)
        if params_path is None:
            net.set_params(init)
        return net

    monkeypatch.setattr(driver, "_load_model", from_jax_init)
    monkeypatch.setattr(jmesh, "data_parallel_mesh",
                        lambda n_devices=None, devices=None: one_device(1))
    args += ["--batch", "50"]
    assert jmain(args + ["--model", str(tmp_path / "jax.npz")]) == 0
    assert main(args + ["--model", str(tmp_path / "port.npz")]) == 0
    want = np.load(tmp_path / "jax.npz")["params"]
    got = np.load(tmp_path / "port.npz")["params"]
    assert got.shape == want.shape and not np.allclose(want, init)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_runtime_parallel_two_gloo_ranks_match_jax(conf_path, iris_csv,
                                                         tmp_path,
                                                         monkeypatch):
    """``train --runtime parallel`` under a launcher: two processes join
    one gloo group through DL4J_COORDINATOR / DL4J_NUM_PROCESSES /
    DL4J_PROCESS_ID, train one network over both ranks, and only the
    coordinator writes ``--model``. From the same initial params its
    params equal the JAX CLI's on ``data_parallel_mesh(2)`` within ATOL
    (batches of 45 rows: the last batch of 15 pads one row)."""
    from deeplearning4j_tpu.cli import driver as jdriver
    from deeplearning4j_tpu.parallel import mesh as jmesh

    init = driver._load_model(conf_path, None, "cpu").params().numpy()
    args = ["train", "--conf", conf_path, "--input", iris_csv, "--labels",
            "3", "--batch", "45", "--runtime", "parallel"]
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   DL4J_COORDINATOR=f"127.0.0.1:{port}",
                   DL4J_NUM_PROCESSES="2", DL4J_PROCESS_ID=str(rank))
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli.driver",
             *args, *CPU, "--model", str(tmp_path / f"rank{rank}.npz")],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank}:\n{logs[rank]}"
    assert not (tmp_path / "rank1.npz").exists()

    load, two_devices = jdriver._load_model, jmesh.data_parallel_mesh

    def from_port_init(path, params_path):
        net = load(path, params_path)
        if params_path is None:
            net.set_params(init)
        return net

    monkeypatch.setattr(jdriver, "_load_model", from_port_init)
    monkeypatch.setattr(jmesh, "data_parallel_mesh",
                        lambda n_devices=None, devices=None: two_devices(2))
    assert jmain(args + ["--model", str(tmp_path / "jax.npz")]) == 0
    want = np.load(tmp_path / "jax.npz")["params"]
    got = np.load(tmp_path / "rank0.npz")["params"]
    assert got.shape == want.shape and not np.allclose(want, init)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fleet_subcommand_exits_naming_its_slice():
    """``fleet`` forwards to serve.fleet.replica_main, ``--watch``
    included, which exits naming what is wrong (two model sources)
    before any engine is built."""
    with pytest.raises(SystemExit, match="exactly one"):
        driver.main(["fleet", "--replica", "--tracker", "127.0.0.1:1",
                     "--synthetic", "61,16,2,4,32,2", "--device", "cpu",
                     "--watch", "--checkpoint", "x"])


def test_gs_store_raises_naming_its_slice(monkeypatch):
    """The gs:// store and the adapters are ported: without the
    google-cloud-storage package gs:// fails as the JAX package's does,
    naming the package, and the adapters work over mem://. The package is
    hidden from the import (a real client would look for credentials
    over the network)."""
    import sys

    from deeplearning4j_tpu.scaleout import blobstore as jbs
    from deeplearning4j_tpu_torch.scaleout import blobstore

    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    cloud = sys.modules.get("google.cloud")
    if cloud is not None:
        monkeypatch.delattr(cloud, "storage", raising=False)
    for mod in (jbs, blobstore):
        with pytest.raises(RuntimeError, match="google-cloud-storage"):
            mod.open_store("gs://bucket/prefix")
    store = blobstore.open_store("mem://cli-test-store")
    blobstore.BlobDataSetIterator.write_batch(store, "b/0.npz",
                                              np.ones((2, 3)), np.eye(2))
    batches = list(blobstore.BlobDataSetIterator(store, "b/"))
    assert len(batches) == 1 and batches[0].features.shape == (2, 3)
    assert not blobstore.BlobModelSaver(store).exists()


def test_blob_stores_match_jax(tmp_path):
    from deeplearning4j_tpu.scaleout import blobstore as jbs
    from deeplearning4j_tpu_torch.scaleout import blobstore as tbs

    for mod, sub in ((jbs, "j"), (tbs, "t")):
        local = mod.open_store(f"file://{tmp_path / sub}")
        mem = mod.open_store(f"mem://blob-parity-{sub}")
        for store in (local, mem):
            store.put("a/b.bin", b"xy")
            store.put("c.bin", b"z")
            assert store.get("a/b.bin") == b"xy"
            assert store.list() == ["a/b.bin", "c.bin"]
            assert store.list("a/") == ["a/b.bin"]
            assert store.try_get("nope") is None
            store.delete("c.bin")
            assert not store.exists("c.bin")
            for key in ("../x", "/abs", ""):
                with pytest.raises(ValueError, match="invalid blob key"):
                    store.put(key, b"")
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    assert tbs.open_store("mem://blob-parity-t") is \
        tbs.open_store("mem://blob-parity-t/")


def test_module_entry_point_runs_in_a_subprocess(tmp_path, conf_path,
                                                 iris_csv):
    model = str(tmp_path / "params.npz")
    main(["train", "--conf", conf_path, "--input", iris_csv, "--model",
          model, "--labels", "3", "--batch", "150"])
    out = str(tmp_path / "sub.txt")
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli.driver",
         "predict", "--conf", conf_path, "--input", iris_csv, "--model",
         model, "--labels", "3", "--batch", "150", "--output", out,
         *CPU], cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    main(["predict", "--conf", conf_path, "--input", iris_csv, "--model",
          model, "--labels", "3", "--batch", "150", "--output",
          str(tmp_path / "inproc.txt")])
    assert open(out).read() == (tmp_path / "inproc.txt").read_text()


def test_pyproject_names_the_port_script():
    text = (REPO / "pyproject.toml").read_text()
    assert 'dl4j-tpu-torch = "deeplearning4j_tpu_torch.cli.driver:main"' \
        in text
    assert driver.build_parser().prog == "dl4j-tpu-torch"
