"""Dense decoder of the port: layers, attention step, transformer decode."""
