"""Bridge datapath of the port: memport table, steering, loopback bridge, paged KV."""
