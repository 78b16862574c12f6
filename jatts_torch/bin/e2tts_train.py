"""E2-TTS training CLI, tts2 stage 3 (counterpart of jatts_tpu/bin/e2tts_train.py).

A thin alias over ``bin/tts_train.py``: ``model_type: E2TTS`` with
``trainer_type: E2TTSTrainer``; frame-budget batching comes from
``batch_size_per_gpu``, the EMA from ``ema_decay``:

    python -m jatts_torch.bin.e2tts_train --train-csv dump/train.csv --dev-csv dump/dev.csv \\
        --stats dump/stats.npz --token-list data/tokens.txt \\
        --config egs/hificaptain_jp_female/tts2/conf/e2tts.v1.yaml --outdir exp/e2tts --attn-backend flash
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

from jatts_torch.bin.tts_train import main

if __name__ == "__main__":
    main()
