"""Counterpart of ``deeplearning4j_tpu/cli/driver.py``: the CLI driver (ref:
cli/driver/CommandLineInterfaceDriver.java +
cli/subcommands/{Train,Test,Predict}.java).

The parser, flags, defaults and messages are the JAX CLI's, plus
``--device {cuda,cpu}`` (default ``cuda``), the port's counterpart of
``JAX_PLATFORMS``: every subcommand runs on the card unless it is given
``--device cpu``, and raises when CUDA is asked for and absent. The
``params.npz`` it writes holds the flat parameter vector in the JAX
package's order, so a model trained by either CLI loads in the other.

    python -m deeplearning4j_tpu_torch.cli.driver train --conf c.json \\
        --input train.csv --model params.npz --labels 10

``train --runtime parallel`` trains through
``parallel.ParameterAveragingTrainer`` over the process group's ranks.
``fleet`` forwards its arguments to ``serve.fleet.replica_main`` (a
serving-fleet replica; its own parser owns the flags, ``--device``
among them). ``train --profile DIR`` records the training under
``utils.profiling.trace`` (torch.profiler: CPU activity and, on the card,
the CUDA kernels) and writes a Chrome trace into DIR.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.records import (
    CSVRecordReader,
    RecordReaderDataSetIterator,
    SVMLightRecordReader,
)
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _make_iterator(path: str, batch: int, num_labels: Optional[int],
                   num_features: Optional[int], label_index: int):
    """Extension-dispatched reader (ref Train.java input-format handling)."""
    if path.endswith((".svm", ".svmlight", ".libsvm")):
        if not num_features:
            raise SystemExit("--features is required for svmLight input")
        reader = SVMLightRecordReader(path, num_features)
    else:
        reader = CSVRecordReader(path)
    return RecordReaderDataSetIterator(reader, batch,
                                       label_index=label_index,
                                       num_possible_labels=num_labels)


def _npz_path(path: str) -> str:
    # np.savez appends .npz to extension-less paths; normalize both ends so
    # `--model m` round-trips between train and test/predict
    return path if path.endswith(".npz") else path + ".npz"


def _load_params(path: str) -> np.ndarray:
    """--model accepts plain paths or blob-store URIs (ref: the CLI's URI
    Scheme registry, cli/api/schemes/ — here file:// and mem://)."""
    if "://" in path:
        import io

        from deeplearning4j_tpu_torch.scaleout.blobstore import open_store, \
            split_store_uri

        uri, key = split_store_uri(_npz_path(path))
        with np.load(io.BytesIO(open_store(uri).get(key))) as z:
            return z["params"]
    return np.load(_npz_path(path))["params"]


def _load_model(conf_path: str, params_path: Optional[str],
                device: str) -> MultiLayerNetwork:
    with open(conf_path, "r", encoding="utf-8") as f:
        conf = MultiLayerConfiguration.from_json(f.read())
    net = MultiLayerNetwork(conf, device=device).init()
    if params_path:
        net.set_params(_load_params(params_path))
    return net


def _host(x) -> np.ndarray:
    """A tensor on the card as a host array (the CLI's file seams)."""
    return x.detach().cpu().numpy()


def _save_model(net: MultiLayerNetwork, path: str) -> None:
    if "://" in path:
        import io

        from deeplearning4j_tpu_torch.scaleout.blobstore import open_store, \
            split_store_uri

        uri, key = split_store_uri(_npz_path(path))
        buf = io.BytesIO()
        np.savez(buf, params=_host(net.params()))
        open_store(uri).put(key, buf.getvalue())
        return
    np.savez(_npz_path(path), params=_host(net.params()))


def train(args) -> int:
    import contextlib

    if getattr(args, "profile", None):
        from deeplearning4j_tpu_torch.utils.profiling import trace as _trace

        profile_ctx = _trace(args.profile)
    else:
        profile_ctx = contextlib.nullcontext()
    with profile_ctx:
        if args.runtime == "parallel":
            rc = _train_parallel(args)
        else:
            rc = _train_local(args)
    if getattr(args, "profile", None) and args.verbose:
        print(f"wrote a torch.profiler trace to {args.profile}")
    return rc


def _train_local(args) -> int:
    net = _load_model(args.conf, None, args.device)
    it = _make_iterator(args.input, args.batch, args.labels,
                        args.features, args.label_index)
    for _ in range(args.epochs):
        it.reset()
        net.fit(it)
    _save_model(net, args.model)
    if args.verbose:
        print(f"saved params to {args.model}")
    return 0


def _train_parallel(args) -> int:
    """Data-parallel over the process group's ranks (ref
    Train.execOnSpark dispatch → the mesh trainer with averaging). Each
    process joins the group named by DL4J_COORDINATOR /
    DL4J_NUM_PROCESSES / DL4J_PROCESS_ID (none set: one rank), trains on
    its own device, and only the coordinator writes ``--model``."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
    from deeplearning4j_tpu_torch.parallel.trainer import (
        ParameterAveragingTrainer,
    )

    joined = not dist.is_initialized()
    multihost.initialize(device=args.device)
    try:
        net = _load_model(args.conf, None, args.device)
        it = _make_iterator(args.input, args.batch, args.labels,
                            args.features, args.label_index)
        trainer = ParameterAveragingTrainer(net, data_parallel_mesh())
        for _ in range(args.epochs):
            it.reset()
            trainer.fit_data_set(it)
        if multihost.is_coordinator():
            _save_model(net, args.model)
            if args.verbose:
                print(f"saved params to {args.model}")
    finally:
        if joined:
            multihost.shutdown()
    return 0


def test(args) -> int:
    net = _load_model(args.conf, args.model, args.device)
    it = _make_iterator(args.input, args.batch, args.labels,
                        args.features, args.label_index)
    it.reset()
    if args.labels is None:
        # regression: report MSE/MAE (argmax-based Evaluation on a single
        # label column would always claim 100% accuracy)
        sq = ab = n = 0.0
        while it.has_next():
            ds = it.next()
            err = _host(net.output(ds.features)) - ds.labels
            sq += float((err ** 2).sum())
            ab += float(np.abs(err).sum())
            n += err.size
        print(f"MSE: {sq / max(n, 1):.6f}\nMAE: {ab / max(n, 1):.6f}")
        return 0
    ev = Evaluation()
    while it.has_next():
        ds = it.next()
        ev.eval(ds.labels, _host(net.output(ds.features)))
    print(ev.stats())
    return 0


def _is_lm_checkpoint_dir(path: str) -> bool:
    """A directory holding a committed checkpoint (scaleout/ckpt layout) —
    the serving path's model format; plain ``.npz`` param files keep the
    classic full-forward predict."""
    import os

    if not os.path.isdir(path):
        return False
    from deeplearning4j_tpu_torch.scaleout.ckpt.reshard import latest_step_dir

    return latest_step_dir(path) is not None


def _read_prompts(path: str) -> List[List[int]]:
    """One prompt per line, token ids separated by spaces or commas."""
    prompts: List[List[int]] = []
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.replace(",", " ").strip()
            if not line:
                continue
            try:
                prompts.append([int(t) for t in line.split()])
            except ValueError:
                raise SystemExit(
                    f"{path}:{ln}: prompts must be integer token ids "
                    "(space- or comma-separated)")
    if not prompts:
        raise SystemExit(f"{path}: no prompts found")
    return prompts


def _predict_lm(args) -> int:
    """LM checkpoints generate through the KV-cached decode engine
    (continuous batching: every prompt is submitted up front and the
    scheduler interleaves them through the slots)."""
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine

    engine = DecodeEngine.from_checkpoint(
        args.model, n_heads=args.heads, n_slots=args.slots,
        max_len=args.max_len, serve_dtype=args.serve_dtype,
        eos_id=args.eos_id, seed=args.seed, device=args.device)
    prompts = _read_prompts(args.input)
    reqs = [engine.submit(p, max_new_tokens=args.max_new_tokens,
                          temperature=args.temperature) for p in prompts]
    engine.run_until_idle()
    out = "\n".join(" ".join(str(t) for t in r.generated)
                    for r in reqs) + "\n"
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out)
        if args.verbose:
            print(f"wrote {len(reqs)} generations to {args.output}")
    else:
        sys.stdout.write(out)
    if args.verbose:
        stats = engine.stats()
        print(f"decode engine: {stats['tokens_total']} tokens, "
              f"{stats['decode_steps']} decode steps, mean occupancy "
              f"{stats['occupancy_mean']:.2f}/{stats['slots']} slots, "
              f"serve_dtype={stats['serve_dtype']}")
    return 0


def predict(args) -> int:
    if _is_lm_checkpoint_dir(args.model):
        return _predict_lm(args)
    if not args.conf:
        raise SystemExit("--conf is required unless --model is a sharded "
                         "LM checkpoint directory")
    net = _load_model(args.conf, args.model, args.device)
    it = _make_iterator(args.input, args.batch, args.labels,
                        args.features, args.label_index)
    rows: List[str] = []
    it.reset()
    while it.has_next():
        ds = it.next()
        if args.labels is None:  # regression: raw outputs, not class ids
            out = _host(net.output(ds.features))
            rows.extend(",".join(f"{v:.6f}" for v in row) for row in out)
        else:
            preds = net.predict(ds.features)
            rows.extend(str(int(p)) for p in preds)
    out = "\n".join(rows) + "\n"
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out)
        if args.verbose:
            print(f"wrote {len(rows)} predictions to {args.output}")
    else:
        sys.stdout.write(out)
    return 0


def _fleet(args) -> int:
    from deeplearning4j_tpu_torch.serve.fleet import replica_main

    return replica_main(args.fleet_args)


def _add_common(p: argparse.ArgumentParser, needs_model_in: bool,
                conf_required: bool = True) -> None:
    p.add_argument("--conf", required=conf_required,
                   help="model conf JSON path" +
                        ("" if conf_required else
                         " (not needed for LM checkpoint dirs)"))
    p.add_argument("--input", required=True, help="input data (csv or svmLight)")
    p.add_argument("--model", required=True,
                   help="params .npz path (%s)" %
                        ("read" if needs_model_in else "written"))
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--labels", type=int, default=None,
                   help="number of classes (omit for regression)")
    p.add_argument("--features", type=int, default=None,
                   help="feature count (required for svmLight)")
    p.add_argument("--label-index", type=int, default=-1,
                   help="label column (-1 = last)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default: the GPU; raises "
                        "when CUDA is absent)")
    p.add_argument("--verbose", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dl4j-tpu-torch", description="train/test/predict neural networks"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="fit a model and save params")
    _add_common(p_train, needs_model_in=False)
    p_train.add_argument("--epochs", type=int, default=1)
    p_train.add_argument("--profile", default=None, metavar="DIR",
                         help="capture a device trace of training into DIR")
    p_train.add_argument("--runtime", choices=["local", "parallel"],
                         default="local",
                         help="'parallel' = data-parallel over the ranks of "
                              "the torch.distributed process group (one "
                              "rank when none is initialised)")
    p_train.set_defaults(func=train)

    p_test = sub.add_parser("test", help="evaluate a saved model")
    _add_common(p_test, needs_model_in=True)
    p_test.set_defaults(func=test)

    p_pred = sub.add_parser(
        "predict",
        help="write class predictions; with --model pointing at a sharded "
             "LM checkpoint dir, generate text through the KV-cached "
             "decode engine instead")
    _add_common(p_pred, needs_model_in=True, conf_required=False)
    p_pred.add_argument("--output", default=None,
                        help="predictions file (default: stdout)")
    lm = p_pred.add_argument_group(
        "LM generation (when --model is a checkpoint dir; --input is then "
        "a prompts file: one prompt per line of token ids)")
    lm.add_argument("--max-new-tokens", type=int, default=32)
    lm.add_argument("--temperature", type=float, default=0.0,
                    help="<= 0 = greedy decode")
    lm.add_argument("--heads", type=int, default=None,
                    help="n_heads when the checkpoint meta lacks it")
    lm.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots (continuous batching)")
    lm.add_argument("--max-len", type=int, default=256,
                    help="KV-cache positions per slot (prompt + generation)")
    lm.add_argument("--serve-dtype", default="bf16",
                    choices=["f32", "bf16", "int8"],
                    help="serving weight precision (serve/quant.py seam)")
    lm.add_argument("--eos-id", type=int, default=None)
    lm.add_argument("--seed", type=int, default=0)
    p_pred.set_defaults(func=predict)

    # the serving-fleet replica process, also reachable as ``python -m
    # deeplearning4j_tpu_torch.serve.fleet``. Arguments pass through
    # verbatim to serve.fleet.replica_main (its parser owns the flags)
    p_fleet = sub.add_parser(
        "fleet",
        help="run a serving-fleet replica (args forwarded to "
             "deeplearning4j_tpu_torch.serve.fleet, e.g. fleet --replica "
             "--tracker HOST:PORT --synthetic V,D,H,E,DFF,L --device cpu)")
    p_fleet.add_argument("fleet_args", nargs=argparse.REMAINDER)
    p_fleet.set_defaults(func=_fleet)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["fleet"]:
        # argparse's REMAINDER drops options that lead it (``fleet
        # --replica ...`` fails to parse, as the JAX CLI's does), so the
        # fleet's arguments bypass the top-level parser
        return _fleet(argparse.Namespace(fleet_args=argv[1:]))
    args = build_parser().parse_args(argv)
    if getattr(args, "device", None) == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
