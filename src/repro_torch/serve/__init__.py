"""Serve side of the port: KV-cache placements and the decode step."""
