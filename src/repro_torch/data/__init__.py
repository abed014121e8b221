"""Data sources of the port (numpy copies of ``repro.data``).  The
ListOps task waits for the bidirectional slice."""
from .pipeline import ZipfLM, HierarchicalLM, file_corpus, Prefetcher

__all__ = ["ZipfLM", "HierarchicalLM", "file_corpus", "Prefetcher"]
