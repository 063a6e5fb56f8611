"""The paper's experiment CLIs on the port (counterpart of ``experiments/``,
laid out as it is): each runs as ``python -m
meta_learning_pacoh_torch.experiments.<path>`` with the original's flags,
defaults and files, and each ``main(argv=None, device=None)`` runs on the
card unless ``device`` names another."""
