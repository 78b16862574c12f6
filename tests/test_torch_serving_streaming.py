"""Streaming serving in the port: a mel artifact with a stream step against
the pcm16 wav artifact of the same FastSpeech2 + HiFi-GAN, and
BatchingServer.submit_stream mixed with submit (counterpart of
tests/test_serving_streaming.py), on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.serving import BatchingServer, build_infer_fn, export_bundle, load_bundle  # noqa: E402
from jatts_torch.serving.bundle import StreamStep  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402

NMELS, MAX_FRAMES, BATCH, CHUNK = 12, 48, 2, 16
FS2 = dict(idim=8, odim=NMELS, adim=16, aheads=2, elayers=1, eunits=32, dlayers=1, dunits=32, postnet_layers=0,
           duration_predictor_chans=8, pitch_predictor_chans=8, pitch_predictor_layers=2,
           energy_predictor_chans=8, conformer_enc_kernel_size=7, conformer_dec_kernel_size=7)
VOC = dict(in_channels=NMELS, channels=8, upsample_scales=(4, 2), upsample_kernel_sizes=(8, 4),
           resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))
HOP = 8


@pytest.fixture(autouse=True)
def one_thread():
    """torch's intra-op threads capped at 1 for each test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The same model and vocoder exported twice: a pcm16 wav artifact and
    a mel artifact with a stream step; both loaded on the CPU."""
    root = tmp_path_factory.mktemp("stream_bundles")
    torch.manual_seed(0)
    model = FastSpeech2(**FS2, device="cpu").eval()
    with torch.no_grad():
        model.duration_predictor.linear.bias.fill_(float(np.log(4.0)))
    gen = HiFiGANGenerator(**VOC, device="cpu")
    rng = np.random.default_rng(1)
    mean, scale = rng.normal(size=NMELS).astype(np.float32), rng.uniform(0.5, 2, NMELS).astype(np.float32)
    voc = type("Voc", (), dict(model=gen, mean=rng.normal(size=NMELS).astype(np.float32),
                               scale=rng.uniform(0.5, 2, NMELS).astype(np.float32)))
    config = {"model_type": "FastSpeech2", "model_params": FS2, "num_mels": NMELS}
    meta = {"model_type": "FastSpeech2", "model_params": FS2, "hop_size": HOP, "max_frames": MAX_FRAMES,
            "num_mels": NMELS}
    fn16, w16 = build_infer_fn(config, model, mean, scale, MAX_FRAMES, vocoder=voc)
    wav_path = export_bundle(str(root / "wav.npz"), fn16, BATCH, [16],
                             dict(meta, output="wav", wav_format="pcm16"), weights=w16)
    fn_mel, w_mel = build_infer_fn(config, model, mean, scale, MAX_FRAMES)
    stream = StreamStep(gen, MAX_FRAMES, NMELS, chunk=CHUNK, voc_mean=voc.mean, voc_scale=voc.scale)
    mel_path = export_bundle(str(root / "mel_stream.npz"), fn_mel, BATCH, [16], dict(meta, output="mel"),
                             weights=w_mel, stream=stream)
    return load_bundle(wav_path, device="cpu"), load_bundle(mel_path, device="cpu")


def test_stream_chunks_equal_the_wav_bundle(bundles):
    wav_bundle, stream_bundle = bundles
    reqs = [[2, 3, 4], [5, 6, 7, 3, 2, 4, 6, 5]]  # ragged: different olens
    ref = wav_bundle.synthesize(reqs, seed=0)
    per_row, starts = [[] for _ in reqs], [[] for _ in reqs]
    for rows in stream_bundle.synthesize_streaming(reqs, seed=0):
        for i, row in enumerate(rows):
            per_row[i].append(row["wav"])
            starts[i].append(row["start_sample"])
    for i in range(len(reqs)):
        got = np.concatenate(per_row[i])
        assert got.dtype == np.int16 and got.shape == ref[i]["wav"].shape and got.size > 0
        # the same mel, the same float samples up to the convolutions'
        # summation order: within 1 LSB of pcm16
        assert np.abs(got.astype(np.int32) - ref[i]["wav"].astype(np.int32)).max() <= 1
        assert starts[i] == [k * CHUNK * HOP for k in range(len(starts[i]))]
    # each row's chunks add up to its own length, not the batch's longest
    assert sum(len(c) for c in per_row[0]) != sum(len(c) for c in per_row[1])


def test_a_wav_bundle_refuses_to_stream(bundles):
    wav_bundle, _ = bundles
    with pytest.raises(ValueError, match="stream"):
        list(wav_bundle.synthesize_streaming([[2, 3]], seed=0))


def test_server_submit_stream_mixed_with_submit(bundles):
    wav_bundle, stream_bundle = bundles
    ref = wav_bundle.synthesize([[2, 3, 4], [6, 5, 4, 3]], seed=0)
    with BatchingServer(stream_bundle, max_delay_ms=5) as server:
        handles = [server.submit_stream(token_ids=[2, 3, 4]), server.submit_stream(token_ids=[6, 5, 4, 3])]
        fut = server.submit(token_ids=[5, 6, 7])  # mixed traffic, the same bundle
        chunks = [[c["wav"] for c in h] for h in handles]
        mel = fut.result(timeout=60)["mel"]
        with pytest.raises(ValueError, match="bucket"):
            server.submit_stream(token_ids=[1] * 17)
        with pytest.raises(TypeError, match="token_ids"):
            server.submit_stream(tokens=[1])
    assert not server._thread.is_alive()
    assert server.stats["requests"] == 3 and server.stats["batches"] >= 2
    for c, r in zip(chunks, ref):
        assert np.abs(np.concatenate(c).astype(np.int32) - r["wav"].astype(np.int32)).max() <= 1
    assert mel.ndim == 2 and mel.shape[1] == NMELS and np.isfinite(mel).all()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit_stream(token_ids=[2])

    with BatchingServer(wav_bundle) as server:
        with pytest.raises(ValueError, match="stream"):
            server.submit_stream(token_ids=[2, 3])
