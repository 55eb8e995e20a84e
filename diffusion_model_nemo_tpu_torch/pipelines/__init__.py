"""Multi-model pipelines of the port: the cascade (a base generator and SR3
upscalers)."""

from .cascade import CascadePipeline, stage_generator

__all__ = ["CascadePipeline", "stage_generator"]
