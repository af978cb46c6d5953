"""REST live-stacking server and web UI of the port, mirror of
nightlight_tpu/serve."""
