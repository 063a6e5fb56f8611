"""Counterpart of experiments/baselines/."""
