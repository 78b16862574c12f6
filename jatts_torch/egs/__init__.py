"""Stage 0 of the recipes (counterparts of ``egs/<corpus>/<tts>/local/*.py``).

``jatts_torch/egs/<corpus>/<tts>/local/<script>.py`` keeps the flags,
defaults, seeds and output of the script of the same path under ``egs/``,
runs on ``jatts_torch`` alone, and runs as a module:

    python -m jatts_torch.egs.jsut.tts1.local.data_prep --db-root downloads/jsut --outdir data

``jatts_torch/bin/run_recipe.py`` drives them with the recipes' other stages.
"""
