"""Hand-written Hopper kernels (CUDA C++ in ``../csrc``), their wrappers
(:mod:`.ops`) and their plain PyTorch versions (:mod:`.ref`)."""
