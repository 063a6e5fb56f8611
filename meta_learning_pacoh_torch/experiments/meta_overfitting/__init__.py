"""Counterpart of experiments/meta_overfitting/."""
