"""``jatts_torch/utils/model_io.py`` against ``jatts_tpu/utils/model_io.py``:
the four cases of ``tests/test_model_io.py`` on a torch module's
state_dict (the JAX helpers on the flax tree of the same layout), and a
frozen module that stays bit for bit through a training step of the
port's Trainer while the rest moves."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from jatts_tpu.utils import model_io as jmodel_io  # noqa: E402
from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.train.steps import fastspeech2_loss  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.model_io import (  # noqa: E402
    filter_modules, freeze_modules_mask, freeze_optimizer, get_partial_params,
)
from tests.test_torch_train_modules import FS2_CONFIG, fs2_batch  # noqa: E402
from tests.test_torch_trainer import LOSSES, FakeLoader, _config  # noqa: E402


class Net(torch.nn.Module):
    def __init__(self, scale, enc_in=2):
        super().__init__()
        self.encoder = torch.nn.Module()
        self.encoder.dense = torch.nn.Linear(enc_in, 3)
        self.decoder = torch.nn.Module()
        self.decoder.dense = torch.nn.Linear(3, 2, bias=False)
        with torch.no_grad():
            for p in self.parameters():
                p.fill_(scale)
            self.encoder.dense.bias.zero_()


def _jax_params(scale):
    """tests/test_model_io.py's tree, the same layout as :class:`Net`."""
    return {
        "encoder": {"dense": {"kernel": jnp.ones((2, 3)) * scale, "bias": jnp.zeros(3)}},
        "decoder": {"dense": {"kernel": jnp.ones((3, 2)) * scale}},
    }


def test_filter_modules():
    assert filter_modules(Net(1.0), ["encoder", "nonexistent"]) == ["encoder"]
    assert filter_modules(Net(1.0).state_dict(), ["encoder", "nonexistent"]) == \
        jmodel_io.filter_modules(_jax_params(1.0), ["encoder", "nonexistent"])


def test_get_partial_params_transfers_matching_shapes():
    merged = get_partial_params(Net(5.0).state_dict(), Net(1.0).state_dict(), ["encoder"])
    jmerged = jmodel_io.get_partial_params(_jax_params(5.0), _jax_params(1.0), ["encoder"])
    np.testing.assert_array_equal(merged["encoder.dense.weight"].numpy(), 5.0 * np.ones((3, 2)))
    np.testing.assert_array_equal(merged["decoder.dense.weight"].numpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(merged["encoder.dense.weight"].numpy().T,
                                  np.asarray(jmerged["encoder"]["dense"]["kernel"]))


def test_get_partial_params_skips_shape_mismatch():
    merged = get_partial_params(Net(5.0, enc_in=9).state_dict(), Net(1.0).state_dict(), ["encoder"])
    np.testing.assert_array_equal(merged["encoder.dense.weight"].numpy(), np.ones((3, 2)))
    np.testing.assert_array_equal(merged["encoder.dense.bias"].numpy(), np.zeros(3))


def test_freeze_modules_mask():
    mask = freeze_modules_mask(Net(1.0), ["decoder"])
    jmask = jmodel_io.freeze_modules_mask(_jax_params(1.0), ["decoder"])
    assert mask == {"encoder.dense.weight": True, "encoder.dense.bias": True, "decoder.dense.weight": False}
    assert jmask["encoder"]["dense"]["kernel"] is True and jmask["decoder"]["dense"]["kernel"] is False


def test_frozen_module_stays_bit_for_bit_through_a_step(tmp_path):
    model = FastSpeech2(**{**FS2_CONFIG, "init_type": "none"}, device="cpu")
    trainer = Trainer(_config(optimizer_type="AdamW", optimizer_params={"lr": 1e-3, "weight_decay": 0.1}),
                      model, {n: LOSS_REGISTRY[n]() for n in LOSSES}, fastspeech2_loss, FakeLoader([]),
                      outdir=str(tmp_path))
    trainer.init_state()
    freeze_optimizer(trainer.optimizer, model, ["encoder", "postnet"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.train_step(fs2_batch(seed=1))
    after = model.state_dict()
    for name, _ in model.named_parameters():
        if name.startswith(("encoder", "postnet")):
            assert torch.equal(after[name], before[name]), name
    moved = [n for n, _ in model.named_parameters() if not torch.equal(after[n], before[n])]
    assert moved and all(not n.startswith(("encoder", "postnet")) for n in moved)
    assert any(n.startswith("decoder") for n in moved)
