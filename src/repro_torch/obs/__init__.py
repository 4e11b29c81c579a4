"""Observability of the port; so far only the host clock."""
