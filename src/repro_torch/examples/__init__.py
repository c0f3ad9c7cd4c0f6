"""Runnable examples (the port's counterparts of the repository's
`examples/`): `python -m repro_torch.examples.<name> --device cuda|cpu`."""
