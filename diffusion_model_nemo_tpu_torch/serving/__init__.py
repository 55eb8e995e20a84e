from .server import BatchingSampler, SamplingServer, serve

__all__ = ["BatchingSampler", "SamplingServer", "serve"]
