"""Checkpoints (:mod:`repro_torch.ckpt.checkpoint`)."""
