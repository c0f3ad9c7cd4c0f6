"""repro_torch — ULEEN training and serving on PyTorch, with Hopper kernels.

A port of the JAX package `repro` that mirrors its subpackages and module
names (`core`, `kernels`, `packed`, `launch`, `obs`, `train`) so each
function's counterpart is found at the same path. It imports nothing of
`repro` and nothing of JAX.

Entry points run on the GPU unless the caller passes `device="cpu"`: with
no CUDA device they raise instead of quietly running on the CPU. On a
CUDA tensor the kernel wrappers (`kernels.packed_wnn`, `fused_wnn`,
`thermometer_encode`, `thermometer_decompress`, `h3_hash`) launch their
hand-written CUDA kernels; on a CPU tensor they run the plain PyTorch
versions in `kernels.ref`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
