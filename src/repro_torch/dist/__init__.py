"""Logical-axis sharding rules and the explicit collectives of the sharded
serve paths (port of `repro/dist/`)."""
