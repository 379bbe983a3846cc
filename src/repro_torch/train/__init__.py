"""Serving (:mod:`repro_torch.train.serve`) and training
(:mod:`repro_torch.train.step`) entry points."""
