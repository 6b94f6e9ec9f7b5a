"""Data pipeline of the port: synthetic token streams and host prefetch
(counterpart of ``repro.data``)."""
from .pipeline import (DataConfig, DataPipeline, SyntheticLMDataset,
                       batch_specs, make_global_batch, rank_rows)
from .tokens import markov_tokens, zipf_tokens

__all__ = ["DataConfig", "SyntheticLMDataset", "DataPipeline",
           "batch_specs", "make_global_batch", "rank_rows", "zipf_tokens", "markov_tokens"]
