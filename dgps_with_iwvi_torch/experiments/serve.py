#!/usr/bin/env python
"""Batch scorer: checkpoint -> predictions file
(port of dgps_with_iwvi_tpu/experiments/serve.py).

Restores a checkpoint written by ``experiments.main`` (``--ckpt_dir``),
rebuilds the model from the ``build_args.json`` beside it (else from the
flags), and scores an input table with the S-sample mixture predictive:
mean, variance and, where targets are given, the per-point log-density,
in original units through the training split's normalization
statistics, as the evaluation path reports them. The dataset goes
through the loader of the model's likelihood, as in training: a
classification model reads its labels as they are, and its mean is the
class probabilities ([n, C] for multiclass and softmax). Runs on the card
unless ``--device cpu`` is given; the live path goes through the hand
kernels.

Batches are fixed-size and padded, ``--depth`` of them in flight. Batch
noise follows the batch's first row, as evaluation's chunks do
(``evaluation.metrics.chunk_seed``). ``--shard`` under ``torchrun
--nproc_per_node N`` splits every batch's rows over the N ranks, each
with the batch's noise for its rows, and gathers them: the per-point
outputs equal the unsharded ones, and rank 0 writes the file.

``--export PATH`` freezes the scorer into one ``torch.export`` artifact
(``serving.export_scorer``: stock ops, parameters and statistics baked
in); ``--from_export PATH`` scores with such an artifact alone, without
the checkpoint or a rebuild.

Examples:
  # score the held-out test split of the training dataset
  python -m dgps_with_iwvi_torch.experiments.serve --dataset kin8nm \\
      --ckpt_dir /tmp/ck --output /tmp/pred.npz

  # export an artifact for the card and the CPU, then score with it
  python -m dgps_with_iwvi_torch.experiments.serve --dataset kin8nm \\
      --ckpt_dir /tmp/ck --export /tmp/scorer.pt2 --export_platforms cuda,cpu
  python -m dgps_with_iwvi_torch.experiments.serve --dataset kin8nm \\
      --from_export /tmp/scorer.pt2 --output /tmp/pred.npz
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dgps_with_iwvi_torch.device import resolve_device
from dgps_with_iwvi_torch.evaluation.metrics import (chunk_seed, merge_rows,
                                                     piece_rows, rank_rows)
from dgps_with_iwvi_torch.experiments.main import (load_data, seeds,
                                                   shard_mesh)
from dgps_with_iwvi_torch.models import (BuildArgs, build_model, layer_noise,
                                         load_build_args)
from dgps_with_iwvi_torch.parallel import distributed
from dgps_with_iwvi_torch.parallel.sharding import gather_rows
from dgps_with_iwvi_torch.serving import (GraphedScore, NormalizationStats,
                                          export_scorer, fixed_batches,
                                          load_scorer, make_scorer_fn,
                                          save_scorer, score_table)
from dgps_with_iwvi_torch.training import TrainConfig, make_trainer
from dgps_with_iwvi_torch.training.checkpoint import (latest_step,
                                                      restore_checkpoint)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="energy",
                   help="training dataset (fixes normalization stats)")
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--configuration", default="G")
    p.add_argument("--mode", default="VI")
    p.add_argument("--M", type=int, default=128)
    p.add_argument("--K", type=int, default=5)
    p.add_argument("--d_w", type=int, default=1)
    p.add_argument("--kernel", default="rbf")
    p.add_argument("--likelihood", default="gaussian")
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--natgrad", default=None,
                   help="TrainState layout of the checkpoint "
                        "(default: from build_args.json, else 'final')")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint directory (required unless --from_export)")
    p.add_argument("--input", default=None,
                   help="npz (arrays X[, Y]) or delimited table of raw X "
                        "rows; default = the dataset's test split")
    p.add_argument("--output", default=None,
                   help="npz output path (required unless only --export)")
    p.add_argument("--export", default=None, metavar="PATH",
                   help="write a self-contained torch.export serving "
                        "artifact (params + normalization baked in; see "
                        "dgps_with_iwvi_torch/serving.py) and, if --output "
                        "is absent, exit without scoring")
    p.add_argument("--export_platforms", default=None,
                   help="comma list of torch devices, e.g. 'cuda,cpu' for "
                        "an artifact that scores on both (default: --device)")
    p.add_argument("--from_export", default=None, metavar="PATH",
                   help="score with a previously exported artifact instead "
                        "of a checkpoint (no model rebuild; single-device; "
                        "--ckpt_dir/--shard ignored)")
    p.add_argument("--num_predict_samples", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=2048,
                   help="scoring batch; with --export, 0 exports a "
                        "POLYMORPHIC-batch artifact (symbolic dim: one "
                        "artifact scores any n with no padding waste)")
    p.add_argument("--depth", type=int, default=8,
                   help="batches in flight")
    p.add_argument("--transport", default="float32",
                   choices=["float32", "bfloat16", "float16"],
                   help="dtype the RESULTS cross the device->host link in; "
                        "compute is untouched (the cast runs on the device "
                        "after the scorer), so the only effect is rounding "
                        "of the delivered values in exchange for half the "
                        "D2H bytes. Outputs are float32 on the host either "
                        "way")
    p.add_argument("--transport_in", default="float32",
                   choices=["float32", "bfloat16"],
                   help="dtype the INPUT table crosses the host->device "
                        "link in (artifact path only). Inputs are upcast "
                        "to f32 on the device, so compute stays f32, but "
                        "this rounds the inputs themselves (~3 decimal "
                        "digits), unlike the output-only --transport")
    p.add_argument("--shard", action="store_true",
                   help="shard scoring rows over the ranks of a torchrun "
                        "launch (params replicated, each batch's noise kept "
                        "per row): per-point outputs equal the unsharded "
                        "ones; a world of one rank does nothing. --export "
                        "and --from_export stay unsharded")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    return p.parse_args(argv)


def _load_input_raw(args, data):
    """-> (X_raw, Y_raw | None) in ORIGINAL units (for raw-unit artifacts).

    The stored test split is train-standardized, so reconstruct raw by
    inverting the exact standardization (data keeps the train stats)."""
    if args.input is None:
        X_raw = np.asarray(data.X_test) * data.X_std + data.X_mean
        Y_raw = np.asarray(data.Y_test) * data.Y_std + data.Y_mean
        return X_raw, Y_raw
    if args.input.endswith(".npz"):
        z = np.load(args.input)
        return (np.asarray(z["X"], np.float64),
                np.asarray(z["Y"], np.float64) if "Y" in z.files else None)
    from dgps_with_iwvi_torch.data.native_loader import parse_table

    return parse_table(args.input), None


def _run_from_export(args) -> dict:
    """Score with a saved artifact: no checkpoint, no rebuild."""
    art = load_scorer(args.from_export, device=args.device)
    if not art.meta.get("raw_units"):
        raise SystemExit(
            "artifact was exported without normalization stats (raw_units="
            "false); score it via dgps_with_iwvi_torch.serving."
            "ServingArtifact in your own units instead")
    print(f"[serve] loaded artifact {args.from_export}: batch="
          f"{art.meta['batch_size']} S={art.meta['num_samples']} "
          f"platforms={art.meta['platforms']} on {art.device}")
    if args.input is None:
        data_kw = {} if args.data_dir is None else {"data_dir": args.data_dir}
        data = load_data(art.meta.get("likelihood", "gaussian"),
                         args.dataset, args.split,
                         num_classes=art.meta.get("num_classes", 3),
                         **data_kw)
    else:
        data = None
    X_raw, Y_raw = _load_input_raw(args, data)
    t0 = time.perf_counter()
    out = art.score(X_raw, Y_raw, seed=args.seed, depth=args.depth,
                    transport=args.transport,
                    transport_in=args.transport_in)
    dt = time.perf_counter() - t0
    n = X_raw.shape[0]
    np.savez(args.output, num_samples=art.meta["num_samples"], **out)
    rate = n / dt
    print(f"[serve] scored {n} points in {dt:.2f}s = {rate:,.0f} points/s "
          f"(artifact, S={art.meta['num_samples']}, "
          f"batch={art.meta['batch_size']}, depth={args.depth}) "
          f"-> {args.output}")
    return {"n": n, "points_per_sec": rate, "output": args.output}


def _load_input(args, data):
    """-> (X_norm, Y_norm | None) in the train-split-standardized space."""
    if args.input is None:  # test split is stored already standardized
        return np.asarray(data.X_test), np.asarray(data.Y_test)
    if args.input.endswith(".npz"):
        z = np.load(args.input)
        X_raw = np.asarray(z["X"], np.float64)
        Y_raw = np.asarray(z["Y"], np.float64) if "Y" in z.files else None
    else:
        from dgps_with_iwvi_torch.data.native_loader import parse_table

        X_raw, Y_raw = parse_table(args.input), None
    Xn = (X_raw - data.X_mean) / data.X_std
    Yn = None if Y_raw is None else (Y_raw - data.Y_mean) / data.Y_std
    return Xn, Yn


def _family(args) -> tuple:
    """(likelihood, num_classes) of the checkpoint's model: from its
    build_args.json, else from the flags."""
    build = load_build_args(args.ckpt_dir)
    if build is None:
        return args.likelihood, args.num_classes
    return build.likelihood, build.num_classes


def _restore(args, data, device):
    """(config, params, step) of the latest checkpoint in --ckpt_dir."""
    # Prefer the BuildArgs that experiments.main writes beside the
    # checkpoint: it records the whole model structure (q_diag, amortized,
    # the fused routes, ...), so any checkpoint restores exactly.
    loaded = load_build_args(args.ckpt_dir, with_meta=True)
    natgrad = args.natgrad
    if loaded is None:
        build = BuildArgs(
            configuration=args.configuration, mode=args.mode.upper(),
            num_inducing=args.M, num_iw_samples=args.K, d_w=args.d_w,
            kernel_kind=args.kernel, likelihood=args.likelihood,
            num_classes=args.num_classes)
        natgrad = natgrad or "final"
        print("[serve] no build_args.json in ckpt_dir; rebuilding from "
              "flags — structure flags like --q_diag/--non_amortized are "
              "NOT representable this way")
    else:
        build, meta = loaded
        natgrad = natgrad or meta.get("natgrad", "final")
        print(f"[serve] model structure from {args.ckpt_dir}/build_args.json"
              f" ({build.configuration} mode={build.mode} M="
              f"{build.num_inducing} K={build.num_iw_samples} "
              f"natgrad={natgrad})")
    X_tr = torch.as_tensor(data.X_train).to(device=device,
                                             dtype=torch.float32)
    Y_tr = torch.as_tensor(data.Y_train).to(device=device,
                                             dtype=torch.float32)
    config, params0 = build_model(seeds(args.seed)[0], build, X_tr, Y_tr,
                                  device=device)
    step = latest_step(args.ckpt_dir)
    if step is None:
        raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
    init_fn, _, _, params_fn = make_trainer(config, TrainConfig(
        natgrad=natgrad))
    state = restore_checkpoint(args.ckpt_dir, step,
                               {"state": init_fn(params0)})["state"]
    print(f"[serve] restored step {step} from {args.ckpt_dir}")
    return config, params_fn(state), step


def _score_live(args, config, params, Xn, Yn, d_y: int, device,
                mesh=None) -> tuple:
    """(outputs, seconds): the standardized table in fixed padded batches
    of --batch_size through the kernels (``serving.score_table``, --depth
    in flight, results narrowed to --transport), each batch's noise from
    the generator seeded by its first row, as evaluation's chunks. On the
    card each batch is one replay of a CUDA graph (``GraphedScore``), as
    the reference jits its scorer. Under a mesh each rank scores its piece
    of every batch with the batch's noise for those rows, and the pieces
    are gathered on every rank, eagerly."""
    n, d_in = Xn.shape
    S = args.num_predict_samples
    fn = make_scorer_fn(params, config, S, device=device)
    bs = min(args.batch_size, n)
    eval_seed = seeds(args.seed)[2]
    starts = [start for start, _, _ in fixed_batches(n, bs)]
    stage = None
    if mesh is None:
        if device.type == "cuda":
            fn = GraphedScore(fn, d_in, d_y, device)
            stage = fn.stage

        def call(i, xb, yb):
            return fn(xb, yb, chunk_seed(eval_seed, starts[i]))
        batches = fixed_batches(n, bs)
    else:
        rows = rank_rows(bs)
        piece = rows.stop - rows.start

        def call(i, xb, yb):
            gen = torch.Generator(device=device).manual_seed(
                chunk_seed(eval_seed, starts[i]))
            noise = layer_noise(config, (S,), bs, gen)
            return fn(xb, yb, None, eps=[None if e is None else
                                         piece_rows(e, rows, 1)
                                         for e in noise])
        # this rank's piece of each batch: the rows past a batch's end (or
        # the table's) are scored on zero noise and dropped when merged
        batches = [(start + rows.start, piece, piece) for start in starts]

    def score(which):
        upto = min(n, max(start + size for start, size, _ in which))
        return score_table(
            call, Xn[:upto], None if Yn is None else Yn[:upto], d_in,
            d_y, which, device, d_mean=config.layers[-1].d_out,
            depth=args.depth, transport=args.transport, stage=stage)

    # the kernels' first use, outside the timed region
    score(batches[:1])
    t0 = time.perf_counter()
    out = score(batches)
    if mesh is not None:
        out = {k: merge_rows(gather_rows(mesh, torch.from_numpy(v))
                             .cpu().numpy(), bs)[:n]
               for k, v in out.items()}
    return out, time.perf_counter() - t0


def run(args) -> dict:
    if args.output is None and args.export is None:
        raise SystemExit("need --output (scoring) and/or --export (artifact)")
    if args.from_export is not None:
        if args.output is None:
            raise SystemExit("--from_export needs --output")
        if args.export is not None:
            raise SystemExit("--from_export cannot re-export; run a "
                             "--ckpt_dir --export pass instead")
        if args.shard:
            print("[serve] --shard ignored: --from_export scores unsharded")
        return _run_from_export(args)
    if args.ckpt_dir is None:
        raise SystemExit("need --ckpt_dir (or --from_export)")
    if args.output is not None and args.batch_size < 1:
        raise SystemExit("--batch_size 0 exports a polymorphic artifact; "
                         "scoring from a checkpoint needs a batch size > 0")
    mesh = None
    if args.shard and args.export is not None:
        print("[serve] --shard ignored: --export writes one artifact "
              "unsharded")
    else:
        mesh = shard_mesh(args, n_k=1)
    lead = mesh is None or distributed.rank() == 0
    device = resolve_device(args.device)
    data_kw = {} if args.data_dir is None else {"data_dir": args.data_dir}
    likelihood, num_classes = _family(args)
    data = load_data(likelihood, args.dataset, args.split,
                     num_classes=num_classes, **data_kw)
    config, params, step = _restore(args, data, device)
    d_in, d_y = data.X_train.shape[1], data.Y_train.shape[1]

    if args.export is not None:
        platforms = (tuple(args.export_platforms.split(","))
                     if args.export_platforms else None)
        exp = export_scorer(
            params, config,
            batch_size="b" if args.batch_size == 0 else args.batch_size,
            d_in=d_in, d_out=d_y, num_samples=args.num_predict_samples,
            stats=NormalizationStats.from_dataset(data),
            platforms=platforms)
        meta = save_scorer(
            args.export, exp, num_samples=args.num_predict_samples,
            has_stats=True,
            extra_meta={"checkpoint_step": step, "dataset": args.dataset,
                        "split": args.split, "likelihood": likelihood,
                        "num_classes": num_classes})
        print(f"[serve] exported torch.export artifact -> {args.export} "
              f"(batch={meta['batch_size']}, S={meta['num_samples']}, "
              f"platforms={meta['platforms']}, raw units)")
        if args.output is None:
            return {"export": args.export, **meta}

    Xn, Yn = _load_input(args, data)
    n = Xn.shape[0]
    S = args.num_predict_samples
    if Yn is None and likelihood == "switched_gaussian":
        raise SystemExit("a switched_gaussian model needs the task-tagged "
                         "Y in --input to score")
    res, dt = _score_live(args, config, params, Xn, Yn, d_y, device, mesh)
    y_std = np.asarray(data.Y_std).reshape(1, -1)
    y_mean = np.asarray(data.Y_mean).reshape(1, -1)
    out = {
        "mean": res["mean"] * y_std + y_mean,            # original units
        "var": res["var"] * y_std ** 2,
        "num_samples": S,
        "checkpoint_step": step,
    }
    if Yn is not None:
        out["log_density"] = (res["log_density"]
                              - float(np.sum(np.log(y_std))))
    rate = n / dt
    if lead:
        np.savez(args.output, **out)
        bs = min(args.batch_size, n)
        print(f"[serve] scored {n} points in {dt:.2f}s = {rate:,.0f} "
              f"points/s (S={S}, batch={bs}, depth={args.depth}) -> "
              f"{args.output}")
    return {"n": n, "points_per_sec": rate, "output": args.output}


def main(argv=None):
    """Console entry point (``dgp-serve-torch``)."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
