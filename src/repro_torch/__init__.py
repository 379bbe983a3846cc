"""PyTorch/CUDA port of the data-driven DVFS scheduler in :mod:`repro`.

The package mirrors :mod:`repro`'s layout and names (``core/…``,
``configs/paper_suite.py``, ``kernels/{gbdt_predict,ops,ref}.py``) and runs
the paper's pipeline end to end: profile the 12-app suite on the simulated
DVFS testbed, fit the oblivious-tree GBDT power and time regressors, turn
them into per-app (P, T) clock-ladder tables, and choose a clock per job in
the deadline-aware event engine. It imports ``torch`` and ``numpy`` and
nothing of ``jax`` or :mod:`repro`.

**What runs on the device.** The fitted ensembles (``feats``,
``thresholds``, ``leaves``), the encoded prediction batches, and the
hand-written CUDA kernel that evaluates them
(``csrc/gbdt_predict.cu``, wrapped by :func:`repro_torch.kernels.ops.
gbdt_predict`). Every table build is one host→device copy of the encoded
batch per regressor, one launch, and one copy back. On CPU tensors the
wrapper takes the kernel's plain PyTorch version instead; it computes the
same fp64 sum in the same tree order, so CPU and CUDA results are equal
bit for bit.

**What stays numpy on the host, deliberately.** The simulator's truth
model with its ``np.random.default_rng`` streams, workload generation,
GBDT *fitting* (the histogram ``bincount``/``cumsum``/``argmax`` split
search), the ordered-target encoding and target decode, the engine's
per-decision bookkeeping and the compiled decision ladders. None of it is
a kernel in the reference either: it is host control flow over small
arrays. Keeping it numpy is what lets the port reproduce the reference bit
for bit — fitted trees array-equal, golden trace digests equal — where
small torch tensors would change summation orders and add a host–device
synchronisation to every scheduling decision.

Entry points run on the card by default (``device="cuda"``) and raise
when CUDA is absent; pass ``device="cpu"`` to run on the CPU (see
:mod:`repro_torch.device`).
"""
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
