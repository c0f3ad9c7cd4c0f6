"""Hand-written Hopper kernels of the serve path and their plain versions.

Each wrapper (`packed_wnn`, `fused_wnn`, `thermometer_encode`,
`thermometer_decompress`) launches its CUDA kernel on CUDA tensors and
counts the launch in its `launches` attribute; on CPU tensors it runs its
plain version from `ref.py` and counts nothing.
"""
from repro_torch.kernels.fused_wnn import fused_wnn
from repro_torch.kernels.packed_wnn import packed_wnn
from repro_torch.kernels.thermometer import (thermometer_decompress,
                                             thermometer_encode)

KERNELS = (packed_wnn, fused_wnn, thermometer_encode, thermometer_decompress)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
