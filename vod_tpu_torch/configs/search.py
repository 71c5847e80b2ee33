"""The search factory configs (own copies of `DenseFactoryConfig`,
`SparseFactoryConfig` and `HybridSearchFactoryConfig` from
`vod_tpu/configs/search.py`, which the port does not import).

The JAX package's configs are frozen, extra-forbidding pydantic models; these
are frozen dataclasses with the same fields, defaults and allowed values,
checked at construction, the same `from_faiss_factory` translation, and the
`config + diff` override on the engine configs. They import no pydantic: the
card's machine has only PyTorch and numpy.
"""

from __future__ import annotations

import dataclasses
import re
import typing as typ

DenseCodec = typ.Literal["flat", "int8", "pq", "ivf", "ivfpq"]
DenseDtype = typ.Literal["float32", "bfloat16", "int8"]

_CHOICES = {
    "codec": ("flat", "int8", "pq", "ivf", "ivfpq"),
    "dtype": ("float32", "bfloat16", "int8"),
    "code_bits": (8, 4),
    "refine": ("none", "int8", "bfloat16", "float32"),
    "rerank": ("none", "int8", "bfloat16", "float32"),
    "kernel": ("scan", "fused"),
}


@dataclasses.dataclass(frozen=True)
class DenseFactoryConfig:
    """Dense index factory (faiss factory strings and qdrant's int8 as one
    explicit codec config). Field comments follow the JAX package's."""

    codec: DenseCodec = "flat"
    dtype: DenseDtype = "bfloat16"  # flat-codec storage dtype
    # pq codec; coarse_dim=None = exhaustive ADC (decode + product scan)
    n_subquantizers: int = 32
    code_bits: typ.Literal[8, 4] = 8  # 8 = PQ{M}x8; 4 = fast-scan PQ{M}x4
    coarse_dim: typ.Optional[int] = 32
    n_candidates: int = 1024
    train_size: typ.Optional[int] = None
    kmeans_iters: int = 10
    use_opq: bool = False
    opq_iters: int = 4
    # exact re-rank of the top k_factor * k against stored rows (faiss
    # `RFlat` / `Refine(SQ8)`); refine_dim stores them in a truncated PCA space
    refine: typ.Literal["none", "int8", "bfloat16", "float32"] = "none"
    refine_dim: typ.Optional[int] = None
    k_factor: int = 4
    # score-aware (anisotropic) PQ training: None = off, "auto", or a ratio
    aniso_eta: typ.Union[None, float, typ.Literal["auto"]] = None
    # ivf / ivfpq codecs (n_clusters None = IVFauto)
    n_clusters: typ.Optional[int] = None
    nprobe: int = 8
    ivf_window: int = 512
    max_windows: typ.Optional[int] = None
    # pq/ivfpq: False drops the PQ codes (requires `refine`)
    keep_codes: bool = True
    # ivfpq only: second-stage re-rank, SOAR spilling
    rerank: typ.Literal["none", "int8", "bfloat16", "float32"] = "none"
    rerank_dim: typ.Optional[int] = None
    spill: bool = False
    soar_lambda: float = 1.0
    # sharding over a device mesh
    sharded: bool = False
    shard_axis: str = "shard"
    # scan
    chunk: int = 131072
    approx_recall: typ.Optional[float] = 0.95  # None = exact top-k
    # "scan", or "fused": the flat/int8 scan and the pq coarse stage through
    # `fused_mips_binned`
    kernel: typ.Literal["scan", "fused"] = "scan"
    fused_bins: int = 512
    fused_tile: int = 0
    # closed-loop knob autotuning after each periodic rebuild (None = off)
    autotune_target_recall: typ.Optional[float] = None
    autotune_queries: int = 256
    autotune_top_k: int = 10
    autotune_measure_time: bool = False

    def __post_init__(self) -> None:
        for name, allowed in _CHOICES.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")
        if self.aniso_eta is not None and self.aniso_eta != "auto" and not isinstance(self.aniso_eta, (int, float)):
            raise ValueError(f"aniso_eta must be None, 'auto' or a number, got {self.aniso_eta!r}")

    @classmethod
    def from_faiss_factory(cls, factory: str, train_size: typ.Optional[int] = None) -> "DenseFactoryConfig":
        """Translate a faiss factory string: `Flat` -> flat/f32;
        `IVF{n},Flat` / `IVFauto,Flat` -> ivf; `...PQ{M}x8...` -> pq with M
        subquantizers (`x4fs` the 4-bit codec); with an `IVF` part -> ivfpq;
        an `OPQ{M}_{d},` prefix enables OPQ and feeds the coarse dim;
        `,RFlat` / `Refine(SQ8)` pick the f32 / int8 re-rank."""
        m_pq = re.search(r"PQ(\d+)x(8|4)", factory)
        m_ivf = re.search(r"IVF(\d+|auto)", factory)
        if m_pq:
            m_opq = re.search(r"OPQ\d+_(\d+)", factory)
            refine = "none"
            if re.search(r"Refine\(SQ8\)", factory):
                refine = "int8"
            elif re.search(r",RFlat", factory):
                refine = "float32"
            if m_ivf:
                n_c = None if m_ivf.group(1) == "auto" else int(m_ivf.group(1))
                return cls(
                    codec="ivfpq", n_clusters=n_c, n_subquantizers=int(m_pq.group(1)),
                    code_bits=int(m_pq.group(2)), use_opq=m_opq is not None, refine=refine,
                    train_size=train_size,
                )
            return cls(
                codec="pq", n_subquantizers=int(m_pq.group(1)), code_bits=int(m_pq.group(2)),
                coarse_dim=min(64, int(m_opq.group(1)) if m_opq else 32), use_opq=m_opq is not None,
                refine=refine, train_size=train_size,
            )
        if "Flat" in factory and factory.strip() == "Flat":
            return cls(codec="flat", dtype="float32")
        if m_ivf:
            n_c = None if m_ivf.group(1) == "auto" else int(m_ivf.group(1))
            return cls(codec="ivf", n_clusters=n_c, train_size=train_size)
        return cls(codec="flat", dtype="bfloat16", train_size=train_size)

    def __add__(self, diff: typ.Optional[typ.Mapping[str, typ.Any]]) -> "DenseFactoryConfig":
        """`config + diff`: the diff's non-None values override; an unknown
        field raises `TypeError`."""
        if diff is None:
            return self
        return dataclasses.replace(self, **{k: v for k, v in dict(diff).items() if v is not None})


@dataclasses.dataclass(frozen=True)
class SparseFactoryConfig:
    """Sparse BM25 factory (BM25 parameters, the impact-postings width and the
    analyzer's options). Field comments follow the JAX package's."""

    k1: float = 1.2
    b: float = 0.75
    max_postings: int = 2048
    language: typ.Optional[str] = None  # analyzer language (stopwords + stemmer)
    lowercase: bool = True
    min_token_len: int = 2
    # stem tokens after the stopword filter, at index and at query time: Porter
    # for English, Snowball for de/es/fr/ru/it/nl/pt/sv/no/da, others unstemmed
    stem: bool = False
    max_vocab: typ.Optional[int] = None
    section_template: str = "{{ title }} {{ content }}"
    # doc-shard the postings over a mesh axis
    sharded: bool = False
    shard_axis: str = "shard"

    def __add__(self, diff: typ.Optional[typ.Mapping[str, typ.Any]]) -> "SparseFactoryConfig":
        """`config + diff`: the diff's non-None values override; an unknown
        field raises `TypeError`."""
        if diff is None:
            return self
        return dataclasses.replace(self, **{k: v for k, v in dict(diff).items() if v is not None})


@dataclasses.dataclass(frozen=True)
class HybridSearchFactoryConfig:
    """Named engine bundle: a dense and a sparse engine config, each optional."""

    dense: typ.Optional[DenseFactoryConfig] = None
    sparse: typ.Optional[SparseFactoryConfig] = None
