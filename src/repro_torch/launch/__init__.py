"""Serving: the WNN micro-batcher (`scheduler.WnnBatcher`)."""
