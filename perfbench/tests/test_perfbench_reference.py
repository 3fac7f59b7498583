"""The plain reference agrees with the port in float64 on the CPU, at a
tiny size of each configuration: the IW objective and every gradient,
two natural-gradient and Adam steps, and the scored mixture predictive,
on the same weights and injected draws."""

import json

import pytest
import torch

from pb_tiny import BENCH, ROOT, driver_of, mix_of
from perfbench import inputs, system
from perfbench.reference import dgp_ref

# the configurations whose cells' drivers compare against this reference
CELL_OF = {w["config"]: w["name"] for w in BENCH["workloads"]
           if driver_of(w["name"]).REFERENCE is dgp_ref}
CONFIGS = sorted(CELL_OF)


def _tree64(tree):
    if isinstance(tree, dict):
        return {k: _tree64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree64(v) for v in tree]
    return tree.double()


def _setup(name):
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{name}.json").read_text())
    cell = CELL_OF[name]
    cfg, _ = driver_of(cell).shrink(cfg, mix_of(cell))
    data = inputs.make_data(cfg["dataset"], 11, torch.device("cpu"))
    specs = dgp_ref.layer_specs(cfg["model"], data.X.shape[1], 1)
    weights = inputs.make_weights(specs, cfg["model"], data.X, 1, 12)
    config = system.port_config(cfg, data.X.shape[1], 1, data.X.shape[0])
    return cfg, data, specs, _tree64(weights), config


def _draws(data, specs, K, B, steps):
    gen = torch.Generator().manual_seed(13)
    return [dgp_ref.draw_train(gen, data.X.shape[0], B, K, specs)
            for _ in range(steps)]


def _eps64(eps):
    return [None if e is None else e.double() for e in eps]


@pytest.mark.parametrize("name", CONFIGS)
def test_objective_and_gradients(name):
    from dgps_with_iwvi_torch import training

    cfg, data, specs, w64, config = _setup(name)
    K, B = cfg["model"]["num_iw_samples"], 32
    X64, Y64 = data.X.double(), data.Y.double()
    (idx, eps), = _draws(data, specs, K, B, 1)
    tc, init = system.trainer(config, dict(
        lr=5e-3, gamma=1e-2, natgrad="final", minibatch_size=B))
    state = init(system.port_params(w64, specs))
    loss_p, g_nat, g_rest = training.loss_and_grads(
        config, tc(), state, X64, Y64, idx=idx, eps=_eps64(eps))
    grads_p = system.leaves(state._replace(rest=g_rest, natvars=g_nat),
                            specs)

    ref = dgp_ref.train(w64, specs, X64, Y64, [(idx, eps)],
                        X64.shape[0], 5e-3, 1e-2, dgp_ref.Arith("f64"))
    assert float(loss_p) == pytest.approx(ref["losses"][0], rel=1e-10)
    grads_p["final.q_S"] = 0.5 * (grads_p["final.q_S"]
                                  + grads_p["final.q_S"].transpose(-1, -2))
    assert set(ref["grads"][0]) <= set(grads_p)
    for k, g in ref["grads"][0].items():
        torch.testing.assert_close(grads_p[k], g, rtol=1e-8,
                                   atol=1e-10 * float(g.abs().max()))


@pytest.mark.parametrize("name", CONFIGS)
def test_natural_gradient_and_adam_steps(name):
    from dgps_with_iwvi_torch import training

    cfg, data, specs, w64, config = _setup(name)
    K, B = cfg["model"]["num_iw_samples"], 32
    X64, Y64 = data.X.double(), data.Y.double()
    draws = _draws(data, specs, K, B, 2)
    tc = training.TrainConfig(lr=5e-3, gamma=1e-2, natgrad="final",
                              minibatch_size=B)
    init, step, _, _ = training.make_trainer(config, tc)
    state = init(system.port_params(w64, specs))
    losses = []
    for idx, eps in draws:
        state, loss = step(state, X64, Y64, idx=idx, eps=_eps64(eps))
        losses.append(float(loss))
    ref = dgp_ref.train(w64, specs, X64, Y64, draws, X64.shape[0], 5e-3,
                        1e-2, dgp_ref.Arith("f64"))
    assert losses == pytest.approx(ref["losses"], rel=1e-10)
    after = system.leaves(state, specs)
    for k, v in ref["params"].items():
        torch.testing.assert_close(after[k].detach(), v, rtol=1e-7,
                                   atol=1e-9)


@pytest.mark.parametrize("name", CONFIGS)
def test_scored_mixture(name):
    from dgps_with_iwvi_torch.models import predict_y_and_log_density

    cfg, data, specs, w64, config = _setup(name)
    S, Bs = 6, 24
    X, Y = data.X[:Bs].double(), data.Y[:Bs].double()
    eps = dgp_ref.draw_score(torch.Generator().manual_seed(3), S, Bs, specs)
    (m, v), ld = predict_y_and_log_density(
        system.port_params(w64, specs), config, X, Y, None, S,
        eps=_eps64(eps))
    mr, vr, ldr = dgp_ref.score(w64, specs, X, Y, eps,
                                dgp_ref.Arith("f64"), block_rows=7)
    torch.testing.assert_close(m, mr, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(v, vr, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(ld, ldr, rtol=1e-9, atol=1e-12)
