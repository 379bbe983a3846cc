"""Runnable examples: ``python -m repro_torch.examples.train_lm`` and
``python -m repro_torch.examples.serve_decode`` (on the card by default;
``--device cpu`` for the CPU)."""
