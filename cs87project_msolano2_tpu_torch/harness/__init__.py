"""The experiment harness (the reference's ``harness/``): the (n, p)
sweep in ``run_experiments``."""
