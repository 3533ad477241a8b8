"""The port's data pipeline: seeded synthetic token, patch and frame
streams and a background prefetcher."""

from .pipeline import PipelineConfig, Prefetcher, TokenPipeline

__all__ = ["PipelineConfig", "Prefetcher", "TokenPipeline"]
