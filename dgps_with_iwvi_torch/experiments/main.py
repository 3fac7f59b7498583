#!/usr/bin/env python
"""UCI experiment runner (port of dgps_with_iwvi_tpu/experiments/main.py).

The reference's flag surface (dataset, split, configuration string of G/L
tokens, mode VI/IW, M inducing points, K importance samples, minibatch
size, iterations, Adam lr, natgrad gamma, the kernel and likelihood
families, the gram's precision switches, hyperparameter priors, the
inducing-feature family and the non-whitened parameterization), plus
``--device``, wired to the port: data -> build_model (k-means Z init) ->
natgrad + Adam training with the monitor and checkpoints -> mixture NLL /
RMSE (and accuracy) evaluation -> one row of the bayesian_benchmarks
sqlite schema. Runs on the card unless ``--device cpu`` is given.
``--shard`` trains and evaluates over the ranks of a launch (``torchrun
--nproc_per_node N``, or a process group the caller made): a ('dp', 'k')
mesh of (N // n_k) x n_k ranks (``parallel``); the results row, the
checkpoints, TensorBoard and the monitor's prints come from rank 0 only.

Example (the paper's flagship configuration):
    python -m dgps_with_iwvi_torch.experiments.main --dataset kin8nm \\
        --configuration LGG --mode IW --K 20 --M 128 --iterations 20000
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch

from dgps_with_iwvi_torch.data import (Dataset, get_classification_data,
                                       get_multiclass_data,
                                       get_regression_data)
from dgps_with_iwvi_torch.device import resolve_device
from dgps_with_iwvi_torch.evaluation import Database, evaluate
from dgps_with_iwvi_torch.models import (BuildArgs, DGPConfig, build_model,
                                         elbo, parse_prior_flag,
                                         save_build_args)
from dgps_with_iwvi_torch.ops import kernels
from dgps_with_iwvi_torch.parallel import distributed, make_mesh
from dgps_with_iwvi_torch.parallel.mesh import mesh_shape
from dgps_with_iwvi_torch.training import TrainConfig, fit, make_trainer
from dgps_with_iwvi_torch.training.checkpoint import (latest_step,
                                                      restore_checkpoint,
                                                      save_checkpoint)
from dgps_with_iwvi_torch.training.monitor import (Monitor,
                                                   hyperparameter_scalars)
from dgps_with_iwvi_torch.utils.flops import device_peak, step_cost


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="energy")
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--configuration", default="G",
                   help="layer tokens: G=GP layer, L=latent-variable layer")
    p.add_argument("--mode", default="VI", choices=["VI", "IW", "vi", "iw"])
    p.add_argument("--M", type=int, default=128, help="inducing points")
    p.add_argument("--K", type=int, default=5, help="importance samples")
    p.add_argument("--num_samples", type=int, default=1, help="VI MC samples S")
    p.add_argument("--num_predict_samples", type=int, default=100)
    p.add_argument("--minibatch_size", type=int, default=512)
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--gamma", type=float, default=1e-2)
    p.add_argument("--gamma_warmup", type=int, default=0,
                   help="linear natgrad step-size warm-up over N steps")
    p.add_argument("--natgrad", default="final",
                   choices=["final", "all", "none"])
    p.add_argument("--schedule", default="joint",
                   choices=["joint", "alternating"])
    p.add_argument("--d_w", type=int, default=1,
                   help="latent dim per LV layer")
    p.add_argument("--kernel", default="rbf",
                   help="leaf kinds rbf|matern12|matern32|matern52|rq|"
                        "cosine|arccosine[0|2]|linear|polynomial|periodic|"
                        "white|constant|coregion<C>x<R>, composable with "
                        "'+'/'*' (e.g. 'rbf+linear', 'rbf*periodic'); "
                        "per-leaf active dims as a '[...]' suffix (e.g. "
                        "'rbf[0:3]*periodic[3]', 'linear[0,2,5]')")
    p.add_argument("--likelihood", default="gaussian",
                   choices=["gaussian", "bernoulli", "student_t",
                            "multiclass", "softmax", "ordinal"],
                   help="observation model; gaussian and student_t use the "
                        "standardized regression loader, bernoulli the "
                        "binary-label loader, multiclass, softmax and "
                        "ordinal the quantile-binned class loader")
    p.add_argument("--num_classes", type=int, default=3,
                   help="multiclass/ordinal: number of classes C")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="data and parameter dtype; the Hopper kernels are "
                        "float32, so float64 runs with --device cpu")
    p.add_argument("--pallas", default="auto", choices=["auto", "on", "off"],
                   help="the whole-conditional kernel K5 on the training "
                        "path ('on'); 'auto' is off, as in the reference")
    p.add_argument("--var_precision", default="default",
                   choices=["highest", "high", "default"],
                   help="precision class of the q-variance matmuls")
    p.add_argument("--solve_precision", default="high",
                   choices=["highest", "high"],
                   help="precision class of the solve path A = Linv Kuf "
                        "and the mean")
    p.add_argument("--solve_bwd_precision", default="auto",
                   choices=["auto", "same", "high", "default"],
                   help="precision class of the solve path's transposed "
                        "dots ('auto': the primal's)")
    p.add_argument("--gram_fwd_precision", default="highest",
                   choices=["highest", "high"],
                   help="precision class of the gram cross-term products "
                        "(kernels.GRAM_FWD_PRECISION; 'high' is the bf16x3 "
                        "split)")
    p.add_argument("--gram_bwd_relax", action="store_true",
                   help="single-pass bf16 for the gram products' "
                        "transposed (gradient) dots "
                        "(kernels.GRAM_BWD_RELAX)")
    p.add_argument("--prior", action="append", default=[],
                   help="hyperparameter prior, repeatable: target=kind(a,b) "
                        "with target in {kernel_variance, lengthscales, "
                        "noise_variance} (or a parameter-path suffix) and "
                        "kind in {gamma, lognormal, gaussian}; e.g. "
                        "--prior 'noise_variance=lognormal(-2,1)'")
    p.add_argument("--mean_function", default="auto",
                   choices=["auto", "zero", "skip", "constant", "linear"],
                   help="GP-layer mean function ('auto': zero on the final "
                        "layer, fixed identity skips between inner layers)")
    p.add_argument("--feature", default="points",
                   choices=["points", "multiscale"],
                   help="inducing-feature family (ops/features.py): "
                        "'multiscale' gives every inducing point a "
                        "trainable Gaussian window (RBF kernel only)")
    p.add_argument("--feature_init_scale", type=float, default=0.1,
                   help="multiscale window width at initialization")
    p.add_argument("--non_amortized", action="store_true",
                   help="per-datapoint q(w) instead of the encoder (small N)")
    p.add_argument("--no_white", action="store_true",
                   help="non-whitened q(u) parameterization")
    p.add_argument("--q_diag", action="store_true",
                   help="diagonal q(u) covariance")
    p.add_argument("--shard", action="store_true",
                   help="train and evaluate over the ranks of a torchrun "
                        "launch: ('dp','k') mesh, minibatch rows over 'dp', "
                        "IW/MC samples over 'k', summed gradients "
                        "(parallel/sharding.py); a world of one rank runs "
                        "unsharded")
    p.add_argument("--n_k", type=int, default=1,
                   help="with --shard: ranks along the IW-sample mesh axis "
                        "(must divide K); the rest go to 'dp'")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_call", type=int, default=500,
                   help="steps per chunk between host syncs")
    p.add_argument("--print_every", type=int, default=1000)
    p.add_argument("--results_db", default="results.db")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--log_dir", default=None,
                   help="TensorBoard dir (needs the tensorboard package)")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--ckpt_every", type=int, default=5000)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --ckpt_dir")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the training loop "
                        "to DIR/trace.json (a chrome trace); it carries the "
                        "program's spans (utils/trace.py): dgps.fit.chunk "
                        "(a chunk's steps), dgps.fit.readback (its mean "
                        "loss to the host), dgps.fit.callback (logging and "
                        "checkpoints), dgps.graphs.capture (the step's "
                        "warm-up and capture) and dgps.graphs.replay (one "
                        "per graphed step)")
    p.add_argument("--max_n", type=int, default=None,
                   help="cap dataset size (smoke tests)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Raise for a flag combination the port refuses, before any work."""
    if args.dtype == "float64" and torch.device(args.device).type == "cuda":
        raise ValueError("--dtype float64: the Hopper kernels are float32; "
                         "run float64 with --device cpu")


def load_data(likelihood: str, dataset: str, split: int, *,
              num_classes: int = 3, **kw) -> Dataset:
    """The loader of the reference's CLI for a likelihood: binary labels
    for bernoulli, `num_classes` quantile-binned labels for multiclass,
    softmax and ordinal, else the standardized regression data."""
    if likelihood == "bernoulli":
        return get_classification_data(dataset, split, **kw)
    if likelihood in ("multiclass", "softmax", "ordinal"):
        return get_multiclass_data(dataset, split, n_classes=num_classes,
                                   **kw)
    return get_regression_data(dataset, split, **kw)


@contextlib.contextmanager
def gram_switches(fwd_precision: str, bwd_relax: bool,
                  kuf_residual: bool | str = "auto"):
    """``kernels.GRAM_FWD_PRECISION``, ``GRAM_BWD_RELAX`` and
    ``GRAM_KUF_RESIDUAL`` set for the duration of a run (the reference
    sets them for the process)."""
    saved = (kernels.GRAM_FWD_PRECISION, kernels.GRAM_BWD_RELAX,
             kernels.GRAM_KUF_RESIDUAL)
    (kernels.GRAM_FWD_PRECISION, kernels.GRAM_BWD_RELAX,
     kernels.GRAM_KUF_RESIDUAL) = (fwd_precision, bwd_relax, kuf_residual)
    try:
        yield
    finally:
        (kernels.GRAM_FWD_PRECISION, kernels.GRAM_BWD_RELAX,
         kernels.GRAM_KUF_RESIDUAL) = saved


def seeds(seed: int) -> tuple:
    """(build, train, eval) seeds from the run's --seed: the counterpart
    of the reference's ``jax.random.split(PRNGKey(seed), 3)``."""
    return tuple(int(s) for s in
                 np.random.SeedSequence(seed).generate_state(3))


@dataclasses.dataclass
class Experiment:
    """The data and the untrained model of one run."""

    data: Dataset
    build: BuildArgs
    config: DGPConfig
    params: dict
    X: torch.Tensor            # standardized train inputs, on the device
    Y: torch.Tensor
    device: torch.device
    dtype: torch.dtype


def setup(args) -> Experiment:
    """Load the dataset and build the untrained model of `args`."""
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    data_kw = {} if args.data_dir is None else {"data_dir": args.data_dir}
    data = load_data(args.likelihood, args.dataset, args.split,
                     num_classes=args.num_classes, max_n=args.max_n,
                     **data_kw)
    if data.synthetic:
        print(f"[data] {args.dataset}: no pre-staged file found -> "
              f"deterministic synthetic surrogate (N={data.N}, D={data.D})")
    X = torch.as_tensor(data.X_train).to(device=device, dtype=dtype)
    Y = torch.as_tensor(data.Y_train).to(device=device, dtype=dtype)
    build = BuildArgs(
        configuration=args.configuration, mode=args.mode.upper(),
        num_inducing=args.M, num_iw_samples=args.K,
        num_samples=args.num_samples, d_w=args.d_w, kernel_kind=args.kernel,
        use_pallas={"auto": "auto", "on": True, "off": False}[args.pallas],
        amortized=not args.non_amortized, likelihood=args.likelihood,
        num_classes=args.num_classes,
        mean_function=args.mean_function, white=not args.no_white,
        q_diag=args.q_diag,
        priors=tuple(parse_prior_flag(s) for s in args.prior),
        feature=args.feature, feature_init_scale=args.feature_init_scale,
        var_precision=args.var_precision,
        solve_precision=args.solve_precision)
    config, params = build_model(seeds(args.seed)[0], build, X, Y,
                                 device=device, dtype=dtype)
    return Experiment(data, build, config, params, X, Y, device, dtype)


def evaluate_model(args, exp: Experiment, params, mesh=None) -> dict:
    """Test metrics of `params` on the run's test split (evaluate's noise
    from the run's eval seed), its rows split over `mesh` if given."""
    data = exp.data
    return evaluate(
        params, exp.config,
        torch.as_tensor(data.X_test).to(exp.dtype),
        torch.as_tensor(data.Y_test).to(exp.dtype), seeds(args.seed)[2],
        y_std=data.Y_std, num_samples=args.num_predict_samples,
        likelihood=args.likelihood, mesh=mesh, device=exp.device)


def shard_mesh(args, n_k: int | None = None):
    """The run's ('dp', 'k') mesh under --shard (n_k ranks on 'k', default
    --n_k), or None: joins torchrun's process group (or keeps the
    caller's) before any CUDA tensor exists; a world of one runs
    unsharded, as the reference does with one device."""
    if not args.shard:
        return None
    distributed.initialize(device=args.device)
    world = distributed.world_size()
    if world == 1:
        print("[shard] single rank — running unsharded")
        return None
    mesh = make_mesh(n_k=args.n_k if n_k is None else n_k,
                     device=args.device)
    if distributed.rank() == 0:
        n_dp, n_k = mesh_shape(mesh)
        print(f"[shard] ('dp','k') mesh {n_dp}x{n_k} over {world} ranks")
    return mesh


def run(args) -> dict:
    """Train, evaluate and write one results row; returns the row."""
    check_supported(args)
    with gram_switches(args.gram_fwd_precision, args.gram_bwd_relax):
        return _run(args)


def _run(args) -> dict:
    mesh = shard_mesh(args)
    lead = mesh is None or distributed.rank() == 0   # writes and prints
    exp = setup(args)
    config, params, X, Y, device = (exp.config, exp.params, exp.X, exp.Y,
                                    exp.device)
    _, train_seed, eval_seed = seeds(args.seed)
    if args.ckpt_dir and lead:
        # the model's structure beside the checkpoints
        save_build_args(args.ckpt_dir, exp.build, natgrad=args.natgrad)
    if lead:
        print(f"[model] {args.configuration} mode={config.objective} "
              f"M={args.M} K={args.K} N={exp.data.N} D={exp.data.D} on "
              f"{device}")

    tc = TrainConfig(
        lr=args.lr, gamma=args.gamma, gamma_warmup=args.gamma_warmup,
        natgrad=args.natgrad, schedule=args.schedule,
        minibatch_size=args.minibatch_size, iterations=args.iterations,
        steps_per_call=args.steps_per_call,
        solve_bwd_precision=args.solve_bwd_precision)
    # FLOPs of one step (utils/flops.py), analytic from the configuration:
    # under --shard one rank's step, as the reference's shard_map body
    # counts it. A configuration the count cannot express raises here,
    # before any training.
    cost = step_cost(config, tc, X.shape[0], dtype=exp.dtype,
                     mesh_shape=mesh_shape(mesh) if mesh else None)
    mon = Monitor(print_every=args.print_every if lead else 0,
                  log_dir=args.log_dir if lead else None,
                  scalars_fn=lambda state: hyperparameter_scalars(
                      state.rest, config, tc=tc, step=state.step))
    # sharded: the CPU generator every rank holds (parallel/sharding.py)
    gen = torch.Generator(device="cpu" if mesh else device).manual_seed(
        train_seed)
    last_ckpt = [0]

    def callback(step, mean_loss, state):
        mon(step, mean_loss, state)
        if args.ckpt_dir and step - last_ckpt[0] >= args.ckpt_every:
            save_checkpoint(args.ckpt_dir, step, state, gen, mesh=mesh)
            last_ckpt[0] = step

    state0 = None
    if args.resume and args.ckpt_dir:
        step = latest_step(args.ckpt_dir)
        if step is not None:
            like = {"state": make_trainer(config, tc)[0](params),
                    "generator": gen}
            state0 = restore_checkpoint(args.ckpt_dir, step, like,
                                        mesh=mesh)["state"]
            last_ckpt[0] = step
            if lead:
                print(f"[resume] restored step {step} from {args.ckpt_dir}")

    prof = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    t0 = time.time()
    try:
        with prof:
            trained, _ = fit(gen, config, params, X, Y, tc,
                             callback=callback, state=state0, mesh=mesh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        mon.close()
    train_time = time.time() - t0
    if args.profile_dir and lead:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))

    metrics = evaluate_model(args, exp, trained, mesh)
    nb = min(args.minibatch_size, X.shape[0])
    with torch.no_grad():
        final_elbo = float(elbo(
            trained, config, X[:nb], Y[:nb],
            torch.Generator(device=device).manual_seed(eval_seed),
            data_idx=torch.arange(nb, device=device)))
    # steady-state rate from the monitor (its first record starts the
    # clock); the crude wall-clock rate for very short runs
    steps_per_sec = mon.median_steps_per_sec
    if not math.isfinite(steps_per_sec) or steps_per_sec <= 0:
        steps_per_sec = mon.mean_steps_per_sec
    if not math.isfinite(steps_per_sec) or steps_per_sec <= 0:
        steps_per_sec = args.iterations / train_time

    # nominal and adjusted MFU against the card's bf16 peak (None off a
    # card with a known peak, as the reference writes None)
    _, peak = device_peak(device)
    mfu = mfu_adj = None
    if peak:
        mfu = cost["flops"] * steps_per_sec / peak
        mfu_adj = cost["adjusted_flops"] * steps_per_sec / peak

    row = {
        "dataset": args.dataset, "split": args.split,
        "configuration": args.configuration, "mode": args.mode.upper(),
        "M": args.M, "K": args.K, "num_samples": args.num_samples,
        "minibatch_size": args.minibatch_size, "iterations": args.iterations,
        "lr": args.lr, "gamma": args.gamma,
        **metrics,
        "elbo": final_elbo, "steps_per_sec": steps_per_sec,
        "flops_per_step": cost["flops"],
        "mfu": mfu, "mfu_adjusted": mfu_adj,
        "synthetic_data": exp.data.synthetic, "dtype": args.dtype,
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "train_time_s": train_time,
    }
    if not lead:
        return row
    Database(args.results_db).write_result(row)
    acc = (f"test_accuracy={metrics['test_accuracy']:.4f} "
           if "test_accuracy" in metrics else "")
    print(f"[result] test_loglik={metrics['test_loglik']:.4f} "
          f"test_rmse={metrics['test_rmse']:.4f} {acc}"
          f"({steps_per_sec:.1f} steps/s, {train_time:.1f}s train)")
    return row


def main(argv=None):
    """Console entry point (``dgp-train-torch``)."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
