"""Counterpart of experiments/visualization_tasks/."""
