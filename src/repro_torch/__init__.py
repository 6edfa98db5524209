"""PyTorch + CUDA port of the LeanAttention reproduction.

The package mirrors the JAX reference ``repro`` (``core/``, ``kernels/``,
``models/``, ``configs/``, ``serving/``) and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and numpy and
nothing of JAX or of ``repro``.

Entry points take an explicit ``device`` and default to ``"cuda"``; without
CUDA they raise instead of running on the CPU (pass ``device="cpu"`` to ask
for the CPU, as the tests do). Stream-K decode attention runs through the
hand-written Hopper kernels in :mod:`repro_torch.kernels.lean_decode` on CUDA
tensors and through their plain PyTorch versions on CPU tensors.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
