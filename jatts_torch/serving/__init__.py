"""Serving: the bundles, their export artifact and BatchingServer."""

from jatts_torch.serving.bundle import E2ttsServingBundle, ServingBundle, ValleServingBundle
from jatts_torch.serving.export import (
    build_e2tts_fn,
    build_infer_fn,
    build_valle_fn,
    export_bundle,
    export_e2tts_bundle,
    export_valle_bundle,
    load_bundle,
)
from jatts_torch.serving.server import BatchingServer, StreamHandle

__all__ = [
    "BatchingServer",
    "E2ttsServingBundle",
    "ServingBundle",
    "StreamHandle",
    "ValleServingBundle",
    "build_e2tts_fn",
    "build_infer_fn",
    "build_valle_fn",
    "export_bundle",
    "export_e2tts_bundle",
    "export_valle_bundle",
    "load_bundle",
]
