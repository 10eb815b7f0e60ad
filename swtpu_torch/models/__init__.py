"""The search engine."""

from .search import SearchEngine, SearchResult, search_file

__all__ = ["SearchEngine", "SearchResult", "search_file"]
