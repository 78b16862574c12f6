"""jatts_torch ConformerEncoder against jatts_tpu's on the CPU, in f32.

Weights are made with numpy from a seed on the flax tree and carried into
the port by ``utils/convert.py``. Valid frames are compared at 1e-5; the
port's padded frames must be exactly zero (``zero_pad``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.modules.conformer import ConformerEncoder as JConformer  # noqa: E402
from jatts_tpu.ops.masks import attn_mask as jattn_mask  # noqa: E402
from jatts_torch.modules.conformer import ConformerEncoder  # noqa: E402
from jatts_torch.ops.masks import attn_mask  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ADIM, HEADS, UNITS, IDIM, T = 32, 2, 48, 12, 13
LENS = np.array([T, 9, 4])


def _config(input_layer, normalize_before, ffn):
    return dict(
        attention_dim=ADIM, attention_heads=HEADS, linear_units=UNITS,
        num_blocks=1, input_layer=input_layer, idim=IDIM,
        normalize_before=normalize_before, positionwise_layer_type=ffn,
        pos_enc_layer_type="legacy_rel_pos",
        selfattention_layer_type="legacy_rel_selfattn", cnn_module_kernel=7,
    )


def _port_from_jax(variables, cfg, backend):
    # the encoder's flax tree sits under "encoder" in a FastSpeech2 tree
    wrapped = {c: {"encoder": t} for c, t in variables.items()}
    sd = {
        k[len("encoder."):]: v
        for k, v in fastspeech2_state_dict_from_jax(wrapped).items()
    }
    port = ConformerEncoder(attn_backend=backend, **cfg)
    port.load_state_dict(sd, strict=True)
    return port.eval()


@pytest.mark.parametrize("input_layer,normalize_before,ffn,backend", [
    ("embed", True, "conv1d", "xla"),
    ("embed", True, "conv1d", "flash"),
    (None, True, "conv1d", "xla"),
    (None, True, "conv1d", "flash"),
    ("embed", False, "linear", "xla"),
    ("linear", True, "conv1d", "xla"),
    ("linear", False, "linear", "flash"),
])
def test_conformer_encoder_parity(input_layer, normalize_before, ffn, backend):
    rng = np.random.default_rng(0)
    if input_layer == "embed":
        xs = rng.integers(1, IDIM, size=(len(LENS), T)).astype(np.int32)
    elif input_layer == "linear":  # Dense(idim -> adim), LayerNorm, dropout
        xs = rng.normal(size=(len(LENS), T, IDIM)).astype(np.float32)
    else:
        xs = rng.normal(size=(len(LENS), T, ADIM)).astype(np.float32)
    cfg = _config(input_layer, normalize_before, ffn)
    jmod = JConformer(**cfg)
    mask_j = jattn_mask(jnp.asarray(LENS), T)
    variables = randomize(jmod.init(jax.random.key(0), jnp.asarray(xs), mask_j), 1)
    want = np.asarray(jmod.apply(variables, jnp.asarray(xs), mask_j))

    port = _port_from_jax(variables, cfg, backend)
    xt = torch.from_numpy(xs.astype(np.int64) if input_layer == "embed" else xs)
    with torch.no_grad():
        got = port(xt, attn_mask(torch.from_numpy(LENS), T)).numpy()
    for b, n in enumerate(LENS):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)
    if normalize_before:
        # after_norm of a zeroed frame is its bias, on both sides
        np.testing.assert_allclose(got[2, LENS[2]:], want[2, LENS[2]:], **TOL)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_conformer_ignores_padding_content(backend):
    """What sits in a row's padded frames never reaches its valid frames,
    and the padded frames come out zero before the final LayerNorm."""
    cfg = _config("embed", True, "conv1d")
    torch.manual_seed(0)
    port = ConformerEncoder(attn_backend=backend, **cfg).eval()
    with torch.no_grad():
        for bn in port.modules():
            if isinstance(bn, torch.nn.BatchNorm1d):
                bn.running_mean.normal_(0, 0.1)
                bn.running_var.uniform_(0.5, 1.5)
    lens = torch.tensor([T, 6])
    xs = torch.randint(1, IDIM, (2, T))
    other = xs.clone()
    other[1, 6:] = torch.randint(1, IDIM, (T - 6,))
    with torch.no_grad():
        a = port(xs, attn_mask(lens, T))
        b = port(other, attn_mask(lens, T))
    torch.testing.assert_close(a[1, :6], b[1, :6], rtol=1e-6, atol=1e-6)
    bias = port.after_norm.bias.detach()
    torch.testing.assert_close(a[1, 6:], bias.expand(T - 6, -1), rtol=0, atol=0)
