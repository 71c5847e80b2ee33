"""Tensor ops and kernels (port of `vod_tpu/ops/`).

Modules: `numpy_ops` (normalisation, masked softmax, gathers), `merge`
(weighted union-merge of engine results), `pq` (int8 quantisation) and `mips`
(the `fused_mips_binned` and `fused_mips_topk` CUDA kernels and their plain
versions). The package
imports none of them eagerly, so `types.retrieval` can import `numpy_ops`
without a cycle through `merge`.
"""
