from .pipeline import ObjectStoreDataset, Prefetcher, write_corpus
from .synthetic import synthetic_batch, synthetic_corpus

__all__ = ["ObjectStoreDataset", "Prefetcher", "synthetic_batch",
           "synthetic_corpus", "write_corpus"]
