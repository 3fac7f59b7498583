"""GP math core of the port: kernels, linalg, conditionals, likelihoods,
transforms, precision classes, and the hand-written Hopper kernels."""

from . import (conditionals, hopper, kernels, likelihoods, linalg,
               mean_functions, precision, transforms)

__all__ = [
    "conditionals",
    "hopper",
    "kernels",
    "likelihoods",
    "linalg",
    "mean_functions",
    "precision",
    "transforms",
]
