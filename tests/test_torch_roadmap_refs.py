"""The port's "not ported yet" errors name the ROADMAP queue-1 item that
ports what they refuse: item 8 (parallel) for the sharded trainer,
``--shard`` and sharded evaluation, and the serving CLI's ``--shard``
over more than one card. The items are written out here, so that a
rewrite of ROADMAP.md cannot break this test. The harness refuses a flag
before any work: the run below names a dataset that does not exist,
which would raise FileNotFoundError had loading begun."""

import pytest
import torch

from dgps_with_iwvi_torch.evaluation import evaluate
from dgps_with_iwvi_torch.experiments import main, serve
from dgps_with_iwvi_torch.models import BuildArgs, build_config
from dgps_with_iwvi_torch.training import TrainConfig, fit


def _config():
    return build_config(BuildArgs(configuration="LGG", mode="IW",
                                  num_inducing=4, num_iw_samples=2), 2, 1, 8)


def _sharded_trainer():
    fit(torch.Generator(), _config(), None, torch.zeros(8, 2),
        torch.zeros(8, 1), TrainConfig(), mesh=object())


def _sharded_evaluation():
    evaluate(None, _config(), torch.zeros(3, 2), torch.zeros(3, 1), 0,
             y_std=1.0, mesh=object(), device="cpu")


def _cli(name, *flags):
    """A harness run with `flags`, on a dataset that does not exist."""
    def run():
        main.run(main.parse_args(["--dataset", "no_such_dataset",
                                  "--data_dir", "no_such_dir", *flags]))
    run.__name__ = f"cli_{name}"
    return run


@pytest.mark.parametrize("raise_site,item", [
    (_sharded_trainer, 8),
    (_sharded_evaluation, 8),
    (_cli("shard", "--shard"), 8),
], ids=lambda v: getattr(v, "__name__", str(v)).strip("_"))
def test_not_ported_errors_name_their_queue_item(raise_site, item):
    with pytest.raises(NotImplementedError,
                       match=rf"\(ROADMAP\s+queue {item}\)"):
        raise_site()


def test_serve_shard_over_several_cards_names_item_8(monkeypatch):
    """With two visible cards, dgp-serve-torch --shard refuses before any
    work (no checkpoint or dataset exists here) and names item 8."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = serve.parse_args(["--dataset", "no_such_dataset", "--data_dir",
                             "no_such_dir", "--ckpt_dir", "no_such_ckpt",
                             "--output", "no_such.npz", "--shard"])
    with pytest.raises(NotImplementedError,
                       match=r"\(ROADMAP\s+queue 8\)"):
        serve.run(args)
