"""Data sources of the port (numpy copies of ``repro.data``): the LM
token streams and the ListOps task of the LRA encoder."""
from .listops import ListOps
from .pipeline import ZipfLM, HierarchicalLM, file_corpus, Prefetcher

__all__ = ["ListOps", "ZipfLM", "HierarchicalLM", "file_corpus",
           "Prefetcher"]
