"""Data sources of the port: the procedural image set and LM token
stream (``synthetic``), the prefetching loader and the mesh-sharded
loader (``pipeline``)."""

from repro_torch.data.pipeline import Prefetcher, ShardedLoader
from repro_torch.data.synthetic import SyntheticVision, synthetic_tokens

__all__ = ["SyntheticVision", "synthetic_tokens", "Prefetcher",
           "ShardedLoader"]
