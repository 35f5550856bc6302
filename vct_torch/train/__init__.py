"""Training: the engine (``Trainer``), metrics, checkpoints and the CLI
(``python -m vct_torch.train``)."""
