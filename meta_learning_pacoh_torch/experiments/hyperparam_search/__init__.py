"""Counterpart of experiments/hyperparam_search/."""
