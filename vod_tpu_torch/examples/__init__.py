"""Runnable entry points of the port (`python -m vod_tpu_torch.examples.<name>`),
counterparts of the JAX package's `examples/` scripts."""
