"""jatts_torch FastSpeech2 inference against jatts_tpu's on the CPU, in f32,
and the weight layout round trip through the JAX package's own importer."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.utils.torch_import import convert_fastspeech2  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax  # noqa: E402
from tests.torch_parity import assert_trees_equal, randomize, state_dict_numpy  # noqa: E402

IDIM = 12
CONFIG = dict(
    idim=IDIM, odim=8, adim=32, aheads=2, elayers=1, eunits=48, dlayers=1,
    dunits=48, postnet_layers=3, postnet_chans=16, duration_predictor_chans=16,
    pitch_predictor_layers=2, pitch_predictor_chans=16, energy_predictor_chans=16,
    conformer_dec_kernel_size=7,
)
LENS = np.array([10, 7, 3])
# durations ~ round(exp(log 3 + noise) - 1) ~ 2 per token; seed 0 puts no
# predicted duration within 1e-3 of a rounding boundary
DUR_BIAS = np.log(3.0)


def _jax_model_and_vars(seed=0):
    model = JFastSpeech2(**CONFIG)
    xs = jnp.ones((len(LENS), LENS.max()), jnp.int32)
    variables = model.init(
        jax.random.key(0), xs, jnp.asarray(LENS), 16, method=JFastSpeech2.inference
    )
    variables = randomize(variables, seed)
    variables["params"]["duration_predictor"]["linear"]["bias"][:] = DUR_BIAS
    return model, variables


def _inputs():
    xs = np.random.default_rng(1).integers(1, IDIM, size=(len(LENS), LENS.max()))
    return xs.astype(np.int32) * (np.arange(LENS.max())[None] < LENS[:, None])


def _port(variables, backend="xla"):
    port = FastSpeech2(**CONFIG, attn_backend=backend, device="cpu")
    port.load_state_dict(fastspeech2_state_dict_from_jax(variables), strict=True)
    return port


@pytest.mark.parametrize("backend,max_frames", [("xla", 40), ("flash", 40), ("xla", 12)])
def test_fastspeech2_inference_parity(backend, max_frames):
    model, variables = _jax_model_and_vars()
    xs = _inputs()
    want = model.apply(
        variables, jnp.asarray(xs), jnp.asarray(LENS), max_frames,
        method=JFastSpeech2.inference,
    )
    port = _port(variables, backend)
    with torch.no_grad():
        got = port.inference(
            torch.from_numpy(xs.astype(np.int64)), torch.from_numpy(LENS), max_frames
        )
    np.testing.assert_array_equal(got["duration"].numpy(), np.asarray(want["duration"]))
    np.testing.assert_array_equal(got["olens"].numpy(), np.asarray(want["olens"]))
    assert got["duration"].numpy().sum() > 0
    for key in ("pitch", "energy"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got["feat_gen"].numpy(), np.asarray(want["feat_gen"]), rtol=1e-4, atol=1e-4
    )


def test_predicted_durations_clear_of_rounding_boundaries():
    """Guards the parity test's seed: exp(d) - 1 of every valid token stays
    at least 1e-3 away from .5, so reduction-order noise cannot flip a
    duration."""
    model, variables = _jax_model_and_vars()
    xs = jnp.asarray(_inputs())
    hs, d_masks = model.apply(variables, xs, jnp.asarray(LENS), method=JFastSpeech2.encode)
    d_log = model.apply(
        variables, hs, d_masks,
        method=lambda m, h, dm: m.duration_predictor(h, dm),
    )
    e = np.exp(np.asarray(d_log)) - 1.0
    valid = np.asarray(d_masks)
    assert np.abs(e - np.floor(e) - 0.5)[valid].min() > 1e-3


def test_fastspeech2_layout_round_trip():
    """convert_fastspeech2 (the JAX package's importer of reference
    checkpoints) reads the port's state_dict back into the same variables."""
    model, variables = _jax_model_and_vars(seed=3)
    port = _port(variables)
    back = convert_fastspeech2(state_dict_numpy(port), model)
    assert_trees_equal(back, variables)


def test_fastspeech2_is_cpu_only_when_asked():
    port = FastSpeech2(**CONFIG, device="cpu")
    assert next(port.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FastSpeech2(**CONFIG)
