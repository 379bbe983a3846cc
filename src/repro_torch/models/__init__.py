"""Model substrate: the dense (GQA transformer) and Mamba-1 families, served
through :mod:`repro_torch.models.model`."""
