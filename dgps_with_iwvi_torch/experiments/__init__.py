"""Experiment harness (port of dgps_with_iwvi_tpu/experiments): ``main``
is the UCI regression runner, ``run_suite`` the bayesian_benchmarks-style
sweep runner, ``serve`` the batch scorer of a checkpoint or an exported
artifact."""
