"""Runnable examples, on the card by default (``--device cpu`` for the
CPU): ``python -m repro_torch.examples.quickstart`` (profile, fit,
schedule mc/dc/d-dvfs), ``.schedule_jobs`` (the dry run's per-device
costs as scheduled jobs), ``.train_lm`` and ``.serve_decode``."""
