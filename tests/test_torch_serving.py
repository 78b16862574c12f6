"""jatts_torch ServingBundle against jatts_tpu's ``build_infer_fn`` on the
CPU, in f32, and the port's BatchingServer over it."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.serving.export import build_infer_fn  # noqa: E402
from jatts_tpu.vocoder.hifigan import HiFiGANGenerator as JHiFiGAN  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.serving import BatchingServer, ServingBundle  # noqa: E402
from jatts_torch.utils.convert import (  # noqa: E402
    fastspeech2_state_dict_from_jax,
    hifigan_state_dict_from_jax,
)
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

NMELS, IDIM, MAX_FRAMES, BATCH, BUCKETS = 8, 12, 48, 4, (8, 16)
FS2 = dict(
    idim=IDIM, odim=NMELS, adim=32, aheads=2, elayers=1, eunits=48, dlayers=1,
    dunits=48, postnet_layers=2, postnet_chans=16, duration_predictor_chans=16,
    pitch_predictor_layers=2, pitch_predictor_chans=16, energy_predictor_chans=16,
    conformer_dec_kernel_size=7,
)
VOC = dict(
    in_channels=NMELS, channels=16, upsample_scales=(3, 2), upsample_kernel_sizes=(6, 4),
    resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),),
)
REQUESTS = [[3, 4, 5, 6, 7, 8, 9, 10, 11, 2, 3], [1, 2, 3], [5, 5, 5, 5, 5, 5]]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    stats = {
        k: rng.normal(size=NMELS).astype(np.float32) if "mean" in k
        else rng.uniform(0.5, 2.0, size=NMELS).astype(np.float32)
        for k in ("mel_mean", "mel_scale", "voc_mean", "voc_scale")
    }
    jfs2 = JFastSpeech2(**FS2)
    fvars = randomize(jfs2.init(
        jax.random.key(0), jnp.ones((2, 8), jnp.int32), jnp.array([8, 5]), 16,
        method=JFastSpeech2.inference,
    ), 1)
    fvars["params"]["duration_predictor"]["linear"]["bias"][:] = np.log(3.0)
    jvoc = JHiFiGAN(**VOC)
    vvars = randomize(jvoc.init(jax.random.key(1), jnp.zeros((1, 4, NMELS))), 2)

    fs2 = FastSpeech2(**FS2, attn_backend="flash", device="cpu")
    fs2.load_state_dict(fastspeech2_state_dict_from_jax(fvars), strict=True)
    voc = HiFiGANGenerator(**VOC, device="cpu")
    voc.load_state_dict(hifigan_state_dict_from_jax(vvars), strict=True)
    jax_side = SimpleNamespace(fs2=jfs2, fvars=fvars, voc=jvoc, vvars=vvars)
    return jax_side, fs2, voc, stats


def _bundle(fs2, voc, stats, wav_format, buckets=BUCKETS):
    return ServingBundle(
        fs2, voc, stats["mel_mean"], stats["mel_scale"], batch_size=BATCH,
        buckets=buckets, max_frames=MAX_FRAMES, voc_mean=stats["voc_mean"],
        voc_scale=stats["voc_scale"], wav_format=wav_format,
    )


@pytest.mark.parametrize("requests", [REQUESTS, REQUESTS[1:]])
def test_bundle_matches_build_infer_fn(setup, requests):
    jax_side, fs2, voc, stats = setup
    fn, weights = build_infer_fn(
        {"model_type": "FastSpeech2"}, jax_side.fs2, jax_side.fvars,
        stats["mel_mean"], stats["mel_scale"], MAX_FRAMES,
        vocoder=SimpleNamespace(
            model=jax_side.voc, variables=jax_side.vvars,
            mean=stats["voc_mean"], scale=stats["voc_scale"],
        ),
        wav_format="f32",
    )
    bucket = min(b for b in BUCKETS if b >= max(map(len, requests)))
    xs = np.zeros((BATCH, bucket), np.int32)
    ilens = np.zeros((BATCH,), np.int32)
    for i, ids in enumerate(requests):
        xs[i, : len(ids)] = ids
        ilens[i] = len(ids)
    want = jax.jit(fn)(weights, xs, ilens, np.uint32(0))
    olens = np.asarray(want["olens"])
    hop = voc.hop_size

    got = _bundle(fs2, voc, stats, "f32").synthesize(requests, seed=0)
    assert len(got) == len(requests)
    for i, r in enumerate(got):
        assert r["mel"].shape == (olens[i], NMELS) and r["wav"].shape == (olens[i] * hop,)
        assert olens[i] > 0
        np.testing.assert_allclose(r["mel"], np.asarray(want["mel"])[i, : olens[i]], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["wav"], np.asarray(want["wav"])[i, : olens[i] * hop], rtol=1e-4, atol=1e-4)


def test_bundle_pcm16_quantizes_f32(setup):
    _, fs2, voc, stats = setup
    f32 = _bundle(fs2, voc, stats, "f32").synthesize(REQUESTS)
    pcm = _bundle(fs2, voc, stats, "pcm16").synthesize(REQUESTS)
    for a, b in zip(f32, pcm):
        assert b["wav"].dtype == np.int16 and set(b) == {"wav"}
        want = np.round(np.clip(a["wav"], -1.0, 1.0) * 32767.0)
        assert np.abs(b["wav"].astype(np.int32) - want).max() <= 1


def test_bundle_rejects_bad_requests(setup):
    _, fs2, voc, stats = setup
    bundle = _bundle(fs2, voc, stats, "pcm16")
    with pytest.raises(ValueError, match="batch"):
        bundle.synthesize([[1]] * (BATCH + 1))
    with pytest.raises(ValueError, match="bucket"):
        bundle.synthesize([[1] * (BUCKETS[-1] + 1)])
    with pytest.raises(ValueError, match="wav_format"):
        _bundle(fs2, voc, stats, "wav")


def test_batching_server_matches_alone(setup):
    _, fs2, voc, stats = setup
    # one bucket: the legacy rel-pos encoding depends on the padded length,
    # so "alone" and "batched" are the same program only at one bucket
    bundle = _bundle(fs2, voc, stats, "f32", buckets=BUCKETS[-1:])
    requests = REQUESTS * 2  # 6 requests -> at least two batches of <= 4
    alone = [bundle.synthesize([ids])[0] for ids in requests]
    with BatchingServer(bundle, max_delay_ms=50) as server:
        futures = [server.submit(token_ids=ids) for ids in requests]
        results = [f.result(timeout=60) for f in futures]
        with pytest.raises(ValueError, match="bucket"):
            server.submit(token_ids=[1] * (BUCKETS[-1] + 1))
        with pytest.raises(TypeError, match="token_ids"):
            server.submit(tokens=[1])
    assert server.stats["requests"] == len(requests)
    assert server.stats["batches"] >= 2
    assert server.stats["rows"] == BATCH * server.stats["batches"]
    assert not server._thread.is_alive()
    for r, a in zip(results, alone):
        np.testing.assert_allclose(r["wav"], a["wav"], rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(token_ids=[1])
