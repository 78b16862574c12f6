"""Japanese text -> phonemes (counterpart of jatts_tpu/text/japanese.py).

The reference uses pyopenjtalk for G2P (egs/jsut/tts2/local/data_prep.py:26-90)
and a pyopenjtalk-kana -> hiragana path for the Julius aligner
(utils/prepare_julius.py:23-31). pyopenjtalk (an OpenJTalk C extension) may be
absent, so:

  * ``g2p_phonemes(text)`` uses pyopenjtalk when importable;
  * otherwise ``kana_to_phonemes`` converts kana text directly with a pure-
    python mora table (covers kana transcripts; kanji requires pyopenjtalk).
"""

from __future__ import annotations

from typing import List

# mora -> phoneme sequence (Julius/OpenJTalk phone set)
_DIGRAPHS = {
    "きゃ": "ky a", "きゅ": "ky u", "きょ": "ky o",
    "ぎゃ": "gy a", "ぎゅ": "gy u", "ぎょ": "gy o",
    "しゃ": "sh a", "しゅ": "sh u", "しょ": "sh o",
    "じゃ": "j a", "じゅ": "j u", "じょ": "j o",
    "ちゃ": "ch a", "ちゅ": "ch u", "ちょ": "ch o",
    "にゃ": "ny a", "にゅ": "ny u", "にょ": "ny o",
    "ひゃ": "hy a", "ひゅ": "hy u", "ひょ": "hy o",
    "びゃ": "by a", "びゅ": "by u", "びょ": "by o",
    "ぴゃ": "py a", "ぴゅ": "py u", "ぴょ": "py o",
    "みゃ": "my a", "みゅ": "my u", "みょ": "my o",
    "りゃ": "ry a", "りゅ": "ry u", "りょ": "ry o",
    "てぃ": "t i", "でぃ": "d i", "とぅ": "t u", "どぅ": "d u",
    "ふぁ": "f a", "ふぃ": "f i", "ふぇ": "f e", "ふぉ": "f o",
    "うぃ": "w i", "うぇ": "w e", "うぉ": "w o",
    "つぁ": "ts a", "つぃ": "ts i", "つぇ": "ts e", "つぉ": "ts o",
    "しぇ": "sh e", "じぇ": "j e", "ちぇ": "ch e",
    # ゔ (hiragana vu): _kata_to_hira runs BEFORE the digraph lookup, so the
    # keys must be hiragana — katakana ヴ* keys were unreachable
    "いぇ": "y e", "ゔぁ": "b a", "ゔぃ": "b i", "ゔぇ": "b e", "ゔぉ": "b o",
    "ゔゅ": "by u",
}

_SMALL_FALLBACK = {
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゃ": "a", "ゅ": "u", "ょ": "o", "ゎ": "a",
}

_MONO = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "k a", "き": "k i", "く": "k u", "け": "k e", "こ": "k o",
    "が": "g a", "ぎ": "g i", "ぐ": "g u", "げ": "g e", "ご": "g o",
    "さ": "s a", "し": "sh i", "す": "s u", "せ": "s e", "そ": "s o",
    "ざ": "z a", "じ": "j i", "ず": "z u", "ぜ": "z e", "ぞ": "z o",
    "た": "t a", "ち": "ch i", "つ": "ts u", "て": "t e", "と": "t o",
    "だ": "d a", "ぢ": "j i", "づ": "z u", "で": "d e", "ど": "d o",
    "な": "n a", "に": "n i", "ぬ": "n u", "ね": "n e", "の": "n o",
    "は": "h a", "ひ": "h i", "ふ": "f u", "へ": "h e", "ほ": "h o",
    "ば": "b a", "び": "b i", "ぶ": "b u", "べ": "b e", "ぼ": "b o",
    "ぱ": "p a", "ぴ": "p i", "ぷ": "p u", "ぺ": "p e", "ぽ": "p o",
    "ま": "m a", "み": "m i", "む": "m u", "め": "m e", "も": "m o",
    "や": "y a", "ゆ": "y u", "よ": "y o",
    "ら": "r a", "り": "r i", "る": "r u", "れ": "r e", "ろ": "r o",
    "わ": "w a", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "N",
    "ゔ": "b u",
    "っ": "q",  # sokuon -> cl below
    "ー": ":",  # chouon marker, handled as vowel lengthening
    "、": "pau", "。": "sil", "！": "sil", "？": "sil", " ": "pau", "　": "pau",
}


def _kata_to_hira(text: str) -> str:
    return "".join(
        chr(ord(c) - 0x60) if "ァ" <= c <= "ヶ" else c for c in text
    )


def kana_to_phonemes(kana: str) -> List[str]:
    """Kana string -> phoneme list (pure python mora table)."""
    kana = _kata_to_hira(kana)
    phones: List[str] = []
    i = 0
    while i < len(kana):
        if i + 1 < len(kana) and kana[i : i + 2] in _DIGRAPHS:
            phones.extend(_DIGRAPHS[kana[i : i + 2]].split())
            i += 2
            continue
        c = kana[i]
        if c == "っ":
            phones.append("cl")
        elif c == "ー":
            if phones and phones[-1] in "aiueo":
                phones.append(phones[-1])
        elif c in _MONO:
            p = _MONO[c]
            if p not in (":", "q"):
                phones.extend(p.split())
        elif c in _SMALL_FALLBACK:
            # a small kana that did not combine into a digraph (loanword
            # spellings like フィ with an unlisted base): keep its vowel
            # instead of silently dropping the mora
            phones.append(_SMALL_FALLBACK[c])
        i += 1
    return phones


def text_to_kana(text: str) -> str:
    """Text -> kana using pyopenjtalk when available
    (reference utils/prepare_julius.py:23-31)."""
    try:
        import pyopenjtalk  # noqa: PLC0415

        return pyopenjtalk.g2p(text, kana=True)
    except ImportError:
        return text  # assume input is already kana


def g2p_phonemes(text: str) -> List[str]:
    """Text -> phoneme list. Uses pyopenjtalk's full-context G2P when
    available (what the reference recipes call,
    egs/jsut/tts2/local/data_prep.py:26-90); pure-python kana fallback."""
    try:
        import pyopenjtalk  # noqa: PLC0415

        return pyopenjtalk.g2p(text).split(" ")
    except ImportError:
        return kana_to_phonemes(text)
