"""In-process serving: ServingBundle, E2ttsServingBundle and BatchingServer."""

from jatts_torch.serving.bundle import E2ttsServingBundle, ServingBundle
from jatts_torch.serving.server import BatchingServer

__all__ = ["BatchingServer", "E2ttsServingBundle", "ServingBundle"]
