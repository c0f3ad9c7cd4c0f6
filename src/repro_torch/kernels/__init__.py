"""Hand-written Hopper kernels and their plain versions.

Each wrapper (`packed_wnn`, `fused_wnn` and their whole-ensemble entries
`packed_wnn_ensemble`, `fused_wnn_ensemble`, `thermometer_encode`,
`thermometer_decompress` on the ULEEN serve path, `h3_hash` on the ULEEN
training path, `flash_attention` on the LM prefill path) launches its
CUDA kernel on CUDA tensors and counts the launch in its `launches`
attribute (`flash_attention` also by shape, in `flash_attention.shapes`);
on CPU tensors it runs its plain version from `ref.py` and counts
nothing. The WNN and hash launches are the registered operators
`repro_torch::wnn_ensemble` and `repro_torch::h3_hash`, which count in
their bodies: a trace with fake tensors records them and counts none.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_wnn import fused_wnn, fused_wnn_ensemble
from repro_torch.kernels.h3_hash import h3_hash
from repro_torch.kernels.packed_wnn import packed_wnn, packed_wnn_ensemble
from repro_torch.kernels.thermometer import (thermometer_decompress,
                                             thermometer_encode)

KERNELS = (packed_wnn, fused_wnn, thermometer_encode, thermometer_decompress,
           h3_hash, flash_attention)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    flash_attention.shapes.clear()
