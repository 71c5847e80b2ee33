"""Utilities of the port (own copies of what it needs from `vod_tpu/utils/`)."""
