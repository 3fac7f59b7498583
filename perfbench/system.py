"""The system under test: the PyTorch/CUDA port, ``dgps_with_iwvi_torch``.

All that the benchmark knows of the program sits here: how a
configuration becomes the port's ``DGPConfig``, how the benchmark's own
weights are laid out as the port's parameter tree, and where the port
keeps a training step's state. The traffic drives the port only through
``training.fit`` and ``serving.Scorer.score``, the calls its users make.
"""

from __future__ import annotations

import torch

PORT = "dgps_with_iwvi_torch"

# the benchmark's names of a latent layer's weights -> the port's path
_ENCODER = {"W1": ("trunk", 0, "W"), "b1": ("trunk", 0, "b"),
            "W2": ("trunk", 1, "W"), "b2": ("trunk", 1, "b"),
            "Wmu": ("mu_head", "W"), "bmu": ("mu_head", "b"),
            "Wlv": ("logvar_head", "W"), "blv": ("logvar_head", "b")}
_KERNEL = ("raw_variance", "raw_lengthscales")


def build_all() -> None:
    """Build every hand kernel of the port (nvcc, in parallel, into the
    port's own build directory inside the checkout; a no-op once built)."""
    from dgps_with_iwvi_torch.ops.hopper import build

    build.build_all()


def port_config(cfg: dict, d_x: int, d_y: int, num_data: int):
    """The port's DGPConfig of a configuration file."""
    from dgps_with_iwvi_torch.models import BuildArgs, build_config

    m, p = cfg["model"], cfg["precision"]
    args = BuildArgs(
        configuration=m["configuration"], mode=m["mode"],
        num_inducing=m["num_inducing"], num_iw_samples=m["num_iw_samples"],
        d_w=m["d_w"], inner_dim_cap=m["inner_dim_cap"],
        encoder_hidden=tuple(m["encoder_hidden"]),
        encoder_init_logvar=m["encoder_init_logvar"],
        noise_variance_init=m["noise_variance"], jitter=m["jitter"],
        kernel_kind=m["kernel"], white=m["white"],
        var_precision=p["var_precision"],
        solve_precision=p["solve_precision"])
    return build_config(args, d_x, d_y, num_data)


def port_params(weights: dict, specs: list) -> dict:
    """The port's parameter tree holding copies of the benchmark's
    weights. An inner GP layer whose width changes carries the fixed skip
    projection eye(d_in, d_out) of the model's definition."""
    layers = []
    for spec, lw in zip(specs, weights["layers"]):
        lw = {k: v.detach().clone() for k, v in lw.items()}
        if spec[0] == "L":
            enc = {"trunk": [{}, {}], "mu_head": {}, "logvar_head": {}}
            for k, path in _ENCODER.items():
                node = enc
                for p in path[:-1]:
                    node = node[p]
                node[path[-1]] = lw[k]
            layers.append({"encoder": enc})
            continue
        _, d_in, d_out, final = spec
        lp = {"kernel": {k: lw[k] for k in _KERNEL}, "Z": lw["Z"],
              "q_mu": lw["q_mu"], "q_sqrt": lw["q_sqrt"]}
        if not final and d_in != d_out:
            lp["mean_W"] = torch.eye(d_in, d_out, dtype=lw["Z"].dtype,
                                     device=lw["Z"].device)
        layers.append(lp)
    return {"layers": layers, "likelihood": {
        k: v.detach().clone() for k, v in weights["likelihood"].items()}}


def trainer(config, tc_kwargs: dict):
    """(TrainConfig factory, the state of the weights) for `config`: the
    step object that every phase of a training cell drives."""
    from dgps_with_iwvi_torch import training

    def tc(**over):
        return training.TrainConfig(**{**tc_kwargs, **over})

    return tc, training.make_trainer(config, tc())[0]


def fit(gen, config, params, X, Y, tc, callback, state):
    from dgps_with_iwvi_torch import training

    return training.fit(gen, config, params, X, Y, tc, callback=callback,
                        state=state)


def leaves(state, specs: list) -> dict:
    """The program's trained tensors under the benchmark's leaf names
    ("<layer>.<key>", "likelihood.raw_noise_variance") and the
    natural-gradient block's (m, S) as "final.q_mu", "final.q_S"."""
    out = {}
    for i, (spec, lp) in enumerate(zip(specs, state.rest["layers"])):
        if spec[0] == "L":
            for k, path in _ENCODER.items():
                node = lp["encoder"]
                for p in path:
                    node = node[p]
                out[f"{i}.{k}"] = node
            continue
        for k in _KERNEL:
            out[f"{i}.{k}"] = lp["kernel"][k]
        for k in ("Z", "q_mu", "q_sqrt"):
            if k in lp:
                out[f"{i}.{k}"] = lp[k]
    out["likelihood.raw_noise_variance"] = \
        state.rest["likelihood"]["raw_noise_variance"]
    nv = state.natvars[0]
    out["final.q_mu"], out["final.q_S"] = nv["q_mu"], nv["q_S"]
    return out


def natvars(state) -> dict:
    """Copies of the natural-gradient block's (m, S, S^-1)."""
    nv = state.natvars[0]
    return {k: nv[k].detach().clone() for k in ("q_mu", "q_S", "q_Sinv")}


def adam_first_moments(state, named: dict) -> dict:
    """{leaf: Adam's first moment} of the named tensors that Adam holds."""
    opt = state.opt_state
    return {k: opt.state[t]["exp_avg"].detach().clone()
            for k, t in named.items()
            if t in opt.state and "exp_avg" in opt.state[t]}


def scorer(params, config, num_samples: int, device):
    from dgps_with_iwvi_torch import serving

    return serving.Scorer(params, config, num_samples, device=device)
