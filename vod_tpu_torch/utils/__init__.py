"""Utilities of the port (own copies of what it needs from `vod_tpu/utils/`:
content fingerprints, jinja templates) and its YAML reader."""
