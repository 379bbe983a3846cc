"""The optimizer (:mod:`repro_torch.optim.adamw`)."""
