"""The port's own copy of the analyzer (`vod_tpu/native/`, which it does not
import): tokenize + FNV-hash texts into term ids, and build BM25 impact
postings.

A ctypes loader compiles `analyzer.cpp` (a byte-for-byte copy) with `g++` on
first use and caches it under `vod_tpu_torch/_build/native/`; pure-Python
fallbacks keep everything working when no compiler is available.
`analyze_texts` / `build_postings` pick the native path when the shared
library loads, and `native_available()` says whether it did.
"""

from .loader import analyze_texts, build_postings, fnv1a_id, native_available

__all__ = ["analyze_texts", "build_postings", "fnv1a_id", "native_available"]
