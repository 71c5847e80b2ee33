"""Tensor ops and kernels (port of `vod_tpu/ops/`).

Modules: `numpy_ops` (normalisation, masked softmax, gathers), `merge`
(weighted union-merge of engine results), `kmeans` (Lloyd k-means), `pq`
(PQ/OPQ codebooks, encoding, ADC, int8 quantisation), `sample` (priority
sampling), `in_batch_negatives`, `topk` (two-stage exact top-k), and
`mips` (the `fused_mips_binned` and `fused_mips_topk` CUDA kernels and
their plain versions). The package
imports none of them eagerly, so `types.retrieval` can import `numpy_ops`
without a cycle through `merge`.
"""
