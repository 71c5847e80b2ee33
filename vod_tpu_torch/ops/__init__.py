"""Tensor ops and kernels (port of `vod_tpu/ops/`).

Modules: `numpy_ops` (normalisation, masked softmax, gathers), `merge`
(weighted union-merge of engine results), `pq` (int8 quantisation) and `mips`
(the `fused_mips_binned` CUDA kernel and its plain version). The package
imports none of them eagerly, so `types.retrieval` can import `numpy_ops`
without a cycle through `merge`.
"""
