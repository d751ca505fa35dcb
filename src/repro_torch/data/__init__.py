from .pipeline import (ByteTokenizer, Request, RequestGenerator,
                       SyntheticCorpus, batches)

__all__ = ["ByteTokenizer", "Request", "RequestGenerator",
           "SyntheticCorpus", "batches"]
