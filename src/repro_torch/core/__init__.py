"""ULEEN core on PyTorch tensors: specs, H3 hashing, Bloom tables,
thermometer encoding, one-shot and multi-shot training, pruning, export
and the deployable artifact."""
