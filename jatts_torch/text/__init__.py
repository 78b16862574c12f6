"""Japanese text front end (counterpart of jatts_tpu/text): G2P
(pyopenjtalk-gated) and kana/phoneme utilities."""

from jatts_torch.text.japanese import g2p_phonemes, kana_to_phonemes, text_to_kana
