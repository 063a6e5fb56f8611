"""Counterpart of experiments/comparison_n_tasks/."""
