"""Serving entry points (:mod:`repro_torch.train.serve`)."""
