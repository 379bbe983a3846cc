"""Device resolution for the port's entry points.

Every entry point (``run_schedule``, ``legacy_run_schedule``,
``PredictionService``, ``EnergyTimePredictor``, ``fit_gbdt``/``GBDTModel``)
takes an explicit ``device`` whose default is ``"cuda"``. On a machine
without CUDA that default raises — naming ``device="cpu"`` as the way to
ask for the CPU — instead of quietly running somewhere else.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device" = DEFAULT_DEVICE
                   ) -> torch.device:
    """Normalize ``device`` to a concrete ``torch.device``.

    ``"cuda"`` resolves to the current card (``cuda:<index>``), so devices
    compare equal to the ``.device`` of the tensors placed on them. Raises
    :class:`RuntimeError` when CUDA is asked for and absent, and
    :class:`ValueError` for device types other than CPU and CUDA."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or "
                         "'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available on "
            "this machine; pass device=\"cpu\" to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
