"""jatts_torch — the PyTorch/CUDA port of jatts_tpu for NVIDIA Hopper.

Module paths mirror ``jatts_tpu`` so each counterpart is easy to find, and
parameters carry the reference PyTorch state_dict keys, so the JAX package's
own importers (``jatts_tpu.utils.torch_import``, ``jatts_tpu.vocoder.convert``)
read the port's ``state_dict()`` unchanged.

The package imports ``torch`` and never ``jax``, ``flax`` or ``jatts_tpu``.
Entry points (``FastSpeech2``, ``HiFiGANGenerator``, ``ServingBundle``,
``bin/align.py``, ``bin/tts_train.py``) run on ``cuda`` unless the caller
passes ``device="cpu"``. Hand-written CUDA kernels
live in ``csrc/`` and are built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
