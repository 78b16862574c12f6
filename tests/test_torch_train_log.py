"""The port's scalar log (``jatts_torch/utils/events.py``, written by
``train/trainer.py``) against the JAX trainer's tensorboardX file: 4 steps
of a tiny FastSpeech2 from the same weights on the same batches (every
dropout 0), a log and an eval interval every 2 steps. Both files are read
with TensorBoard's own reader; their tags and steps are equal, the
``train/*`` values within the trajectory tolerance of
``tests/test_torch_trainer.py`` (rtol 1e-5, atol 1e-6; measured <= 3.5e-7),
the ``eval/*`` values within 1e-4 (``EVAL_TOL``); on the CPU the port writes no ``mem/*`` where the JAX
trainer writes zeros. Also: the port's
reader against TensorBoard's on the same file, the CRC-32C check value, a
corrupted byte refused."""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
event_accumulator = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")

import jax  # noqa: E402

from jatts_tpu.losses import LOSS_REGISTRY as JLOSS  # noqa: E402
from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.train.steps import fastspeech2_loss as jfastspeech2_loss  # noqa: E402
from jatts_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.train.steps import fastspeech2_loss  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax  # noqa: E402
from jatts_torch.utils.events import EventWriter, crc32c, read_scalars  # noqa: E402
from tests.test_torch_train_modules import FS2_CONFIG, fs2_batch  # noqa: E402
from tests.test_torch_trainer import LOSS_TOL, LOSSES, FakeLoader, _config  # noqa: E402

# eval mode reads the BatchNorm running means, which take in the depthwise
# convolution's bias: its true gradient is 0, Adam turns either package's
# rounding noise into steps of either sign, and tests/test_torch_trainer.py
# holds both to the sum of the learning rates; measured 3.7e-5 at step 4
EVAL_TOL = dict(rtol=1e-4, atol=1e-6)


def tb_scalars(logdir):
    """{(tag, step): value} through TensorBoard's EventAccumulator."""
    acc = event_accumulator.EventAccumulator(logdir, size_guidance={event_accumulator.SCALARS: 0})
    acc.Reload()
    return {(tag, e.step): e.value for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)}


def test_scalar_log_matches_the_jax_trainers(tmp_path):
    batches = [fs2_batch(seed=s) for s in range(4)]
    config = _config(train_max_steps=4, log_interval_steps=2, eval_interval_steps=2, save_interval_steps=100)
    jmodel = JFastSpeech2(**FS2_CONFIG)
    jt = JTrainer(config, jmodel, {n: JLOSS[n]() for n in LOSSES}, jfastspeech2_loss, FakeLoader(batches),
                  FakeLoader(batches[:2]), outdir=str(tmp_path / "jax"), mesh=None, seed=0)
    jt.init_state(jt._prep(batches[0], 1))
    init_sd = fastspeech2_state_dict_from_jax(
        jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    model = FastSpeech2(**{**FS2_CONFIG, "init_type": "none"}, device="cpu")
    model.load_state_dict(init_sd, strict=True)
    pt = Trainer(config, model, {n: LOSS_REGISTRY[n]() for n in LOSSES}, fastspeech2_loss, FakeLoader(batches),
                 FakeLoader(batches[:2]), outdir=str(tmp_path / "port"), seed=0)
    pt.init_state()
    jt.run()
    jt.writer.close()  # the async writer holds the last events until closed
    pt.run()
    want, got = tb_scalars(str(tmp_path / "jax")), tb_scalars(str(tmp_path / "port"))
    # the JAX trainer logs mem/* as 0 where its backend gives no statistics
    # (the CPU); the port logs none there
    mem = {k: v for k, v in want.items() if k[0].startswith("mem/")}
    assert set(mem) == {(t, s) for t in ("mem/bytes_in_use_gb", "mem/peak_bytes_gb") for s in (2, 4)}
    assert set(mem.values()) == {0.0}
    want = {k: v for k, v in want.items() if k not in mem}
    assert set(got) == set(want)
    assert {s for _, s in got} == {2, 4}
    tags = {t for t, _ in got}
    assert {"train/loss", "train/grad_norm", "train/mel_loss", "train/lr", "eval/loss", "eval/mel_loss"} <= tags
    assert not any(t.startswith("mem/") for t in tags)
    for key, value in want.items():
        tol = LOSS_TOL if key[0].startswith("train/") else EVAL_TOL
        np.testing.assert_allclose(got[key], value, err_msg=str(key), **tol)
    # the port's reader agrees with TensorBoard's on the port's file
    mine = read_scalars(str(tmp_path / "port"))
    assert {(t, s): v for s, t, v in mine} == got and len(mine) == len(got)


def test_event_file_framing_and_crc(tmp_path):
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    w = EventWriter(str(tmp_path))
    w.add_scalar("train/loss", 1.25, 7)
    w.add_scalar("mem/peak_bytes_gb", 3.5, 7)
    w.close()
    assert read_scalars(str(tmp_path)) == [(7, "train/loss", 1.25), (7, "mem/peak_bytes_gb", 3.5)]
    assert tb_scalars(str(tmp_path)) == {("train/loss", 7): 1.25, ("mem/peak_bytes_gb", 7): 3.5}
    (path,) = glob.glob(os.path.join(str(tmp_path), "events.out.tfevents.*"))
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0x40  # a bit of the last payload
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_scalars(path)
