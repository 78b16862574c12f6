"""Objective evaluation, tts1 stage 5 (counterpart of jatts_tpu/evaluate)."""
