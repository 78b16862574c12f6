"""The port's text front end (jatts_torch/text) against the JAX package's
(jatts_tpu/text) on fixed inputs: kana and G2P, with pyopenjtalk absent and
with a stand-in module in its place, and the Julius post-processing, each
output exactly equal."""

import sys
import types

import pytest

pytest.importorskip("torch")

from jatts_tpu.text import japanese as jja  # noqa: E402
from jatts_tpu.text import julius as jju  # noqa: E402
from jatts_torch import text as ttext  # noqa: E402
from jatts_torch.text import japanese as tja  # noqa: E402
from jatts_torch.text import julius as tju  # noqa: E402

KANA = [
    "こんにちは", "きょうはいいてんきですね。", "がっこう、ですか？", "コーヒーとケーキ",
    "ファイル", "ヴァイオリン", "ティーパーティー", "ちぇっく！", "いぇーい", "ゔゅ", "ふぃ ふぇ　ふぉ",
    "ぁぃぅぇぉ", "しゃしゅしょ", "abc漢字", "", "ーあー", "っ",
]
LAB = ["0.0 0.1 silB", "0.1 0.25 k", "0.25 0.4 o", "0.4 0.43 N", "0.43 0.6 n", "0.6 0.81 i", "0.81 0.9 silE", ""]


def test_kana_and_g2p_without_pyopenjtalk(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyopenjtalk", None)
    for s in KANA:
        assert tja.kana_to_phonemes(s) == jja.kana_to_phonemes(s)
        assert tja.text_to_kana(s) == jja.text_to_kana(s) == s
        assert tja.g2p_phonemes(s) == jja.g2p_phonemes(s) == jja.kana_to_phonemes(s)
        assert tja._kata_to_hira(s) == jja._kata_to_hira(s)
    assert ttext.g2p_phonemes is tja.g2p_phonemes and ttext.kana_to_phonemes is tja.kana_to_phonemes


def test_g2p_goes_through_pyopenjtalk_when_it_is_there(monkeypatch):
    """A stand-in pyopenjtalk: both packages call its g2p the same way."""
    fake = types.ModuleType("pyopenjtalk")
    fake.g2p = lambda text, kana=False: "カナ" if kana else "k a n a"
    monkeypatch.setitem(sys.modules, "pyopenjtalk", fake)
    for s in ("漢字", "かな"):
        assert tja.g2p_phonemes(s) == jja.g2p_phonemes(s) == ["k", "a", "n", "a"]
        assert tja.text_to_kana(s) == jja.text_to_kana(s) == "カナ"
        assert tju.julius_transcript(s) == jju.julius_transcript(s) == "かな"


def test_julius_post_processing_is_equal(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyopenjtalk", None)
    assert tju.parse_lab(LAB) == jju.parse_lab(LAB)
    assert tju.parse_lab(LAB[1:-2]) == jju.parse_lab(LAB[1:-2])  # no sil markers
    _, intervals, start, end = jju.parse_lab(LAB)
    computed = 0
    for hop, fs in ((300, 24000), (256, 22050), (240, 48000)):
        for n in (int(round((float(end) - float(start)) * fs)), 17000, 300 * 57):
            assert tju.expected_total_frames(n, hop) == jju.expected_total_frames(n, hop)
            try:
                want = jju.calculate_frames(n, intervals, hop, fs)
            except AssertionError:
                with pytest.raises(AssertionError):
                    tju.calculate_frames(n, intervals, hop, fs)
                continue
            assert tju.calculate_frames(n, intervals, hop, fs) == want
            computed += 1
    assert computed >= 3
    for start_s, end_s in (("", ""), ("0.1", "0.81"), ("0.1", "")):
        assert tju.cropped_n_samples(start_s, end_s, 24000, 30000) == jju.cropped_n_samples(start_s, end_s, 24000, 30000)
    for s in ("きょうは、いいてんき。", "コーヒー"):
        assert tju.julius_transcript(s) == jju.julius_transcript(s)

    lab_dir = tmp_path / "julius"
    lab_dir.mkdir()
    (lab_dir / "a.lab").write_text("\n".join(LAB), encoding="utf-8")
    (lab_dir / "b.lab").write_text("", encoding="utf-8")
    (lab_dir / "c.lab").write_text("0.0 0.1 silB\n0.1 0.2 silE\n", encoding="utf-8")
    assert tju.lab_to_row_updates(str(lab_dir / "a.lab"), 19000, 300, 24000) == \
        jju.lab_to_row_updates(str(lab_dir / "a.lab"), 19000, 300, 24000)
    assert tju.lab_to_row_updates(str(lab_dir / "b.lab"), 19000, 300, 24000) is None
    rows = [{"sample_id": u, "wav_path": f"{u}.wav", "start": "", "end": ""} for u in ("a", "b", "c", "d")]

    def n_samples(row):
        return int(round((float(row["end"]) - float(row["start"])) * 24000))

    assert tju.post_process_csv_rows(rows, str(lab_dir), 300, 24000, n_samples) == \
        jju.post_process_csv_rows(rows, str(lab_dir), 300, 24000, n_samples)
