"""ULEEN core, serve side: specs, H3 hashing, Bloom lookups, thermometer
encoding and the deployable artifact, on PyTorch tensors."""
