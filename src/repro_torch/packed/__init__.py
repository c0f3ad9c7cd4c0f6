"""Packed-domain inference runtime: uint32 bitplane tables end to end.

`PackedTables` carries an artifact's word planes from load into the
Hopper bitplane kernel (`kernels/packed_wnn.py`) without ever building an
int8 `(M, N_f, E)` table.
"""
from repro_torch.packed.layout import (PackedTables, from_artifact,
                                       from_binary_model, pack_words,
                                       unpack_words, validate_packed_geometry,
                                       word_count)
from repro_torch.packed.runtime import packed_predict, packed_scores

__all__ = ["PackedTables", "from_artifact", "from_binary_model",
           "pack_words", "unpack_words", "validate_packed_geometry",
           "word_count", "packed_predict", "packed_scores"]
