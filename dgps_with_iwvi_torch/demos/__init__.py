"""The demos (ports of the repository's ``demos/toy_1d.py`` and
``demos/multitask_icm.py``): each a compute half that trains and predicts
and returns arrays, and a plot that needs matplotlib."""
