"""Packed-domain inference runtime: uint32 bitplane tables end to end.

`PackedTables` carries an artifact's word planes from load into the
Hopper bitplane kernel (`kernels/packed_wnn.py`) without ever building an
int8 `(M, N_f, E)` table; `StackedPackedTables` stacks a fleet of them
along a tenant axis.
"""
from repro_torch.packed.layout import (PackedTables, StackedPackedTables,
                                       from_artifact, from_binary_model,
                                       pack_words, stack_tenants,
                                       stacked_zeros, unpack_words,
                                       validate_packed_geometry, word_count)
from repro_torch.packed.runtime import (packed_predict, packed_scores,
                                        stacked_predict, stacked_scores)

__all__ = ["PackedTables", "StackedPackedTables", "from_artifact",
           "from_binary_model", "pack_words", "stack_tenants",
           "stacked_zeros", "unpack_words", "validate_packed_geometry",
           "word_count", "packed_predict", "packed_scores",
           "stacked_predict", "stacked_scores"]
