"""Model substrate: the dense, MoE and VLM transformers, Mamba-1, the
Mamba-2 hybrid and the encoder-decoder, served through
:mod:`repro_torch.models.model`."""
