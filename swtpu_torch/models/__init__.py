"""The search engine and the alignment traceback."""

from .align import Alignment, align_top_k, traceback_pair, traceback_pair_affine
from .search import SearchEngine, SearchResult, search_file

__all__ = ["Alignment", "SearchEngine", "SearchResult", "align_top_k", "search_file", "traceback_pair", "traceback_pair_affine"]
