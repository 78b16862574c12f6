"""In-process serving: ServingBundle and BatchingServer."""

from jatts_torch.serving.bundle import ServingBundle
from jatts_torch.serving.server import BatchingServer

__all__ = ["BatchingServer", "ServingBundle"]
