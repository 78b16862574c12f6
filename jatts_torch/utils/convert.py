"""Flax variables of the JAX package -> the port's ``state_dict``.

The inverse of ``jatts_tpu/utils/torch_import.py`` (``t_linear``,
``t_conv1d``, ``t_bn``, …) and of ``jatts_tpu/vocoder/convert.py``
(``_conv_w``, ``_convT_w``). Takes ``{"params": ..., "batch_stats": ...}``
as nested dicts of numpy arrays and returns tensors keyed by the reference
state_dict names, ready for ``load_state_dict``. No JAX is imported: the
caller hands numpy arrays (``jax.device_get`` on its side).

Leaves convert by name and rank:
    Dense kernel [in, out]           -> weight [out, in]
    Conv kernel [k, in, out]         -> weight [out, in, k]  (depthwise [k, 1, C] too)
    ConvTranspose kernel [k, out, in] -> weight [in, out, k]
    Embed embedding                  -> weight
    LayerNorm / BatchNorm scale      -> weight
    BatchNorm mean / var             -> running_mean / running_var
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

# flax module path ("/"-joined) -> reference module path, first match wins
FASTSPEECH2_RENAMES = (
    (r"^encoder/embed_tok$", "encoder/embed/0"),
    (r"^encoder/embed_lin$", "encoder/embed/0"),
    (r"^encoder/embed_ln$", "encoder/embed/1"),
    (r"^(encoder|decoder)/encoders_(\d+)/", r"\1/encoders/\2/"),
    (r"^(\w+_predictor)/conv/conv_(\d+)$", r"\1/conv/\2/0"),
    (r"^(\w+_predictor)/conv/norm_(\d+)$", r"\1/conv/\2/2"),
    (r"^(pitch|energy)_embed$", r"\1_embed/0"),
    (r"^postnet/conv_(\d+)$", r"postnet/postnet/\1/0"),
    (r"^postnet/bn_(\d+)$", r"postnet/postnet/\1/1"),
)

HIFIGAN_RENAMES = (
    (r"^upsample_(\d+)$", r"upsamples/\1/1"),
    (r"^blocks_(\d+)/convs([12])_(\d+)$", r"blocks/\1/convs\2/\3/1"),
    (r"^output_conv$", "output_conv/1"),
)

_LEAF_NAMES = {
    "embedding": "weight",
    "scale": "weight",
    "kernel": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterable:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _rename(module_path: str, renames) -> str:
    for pattern, repl in renames:
        new, n = re.subn(pattern, repl, module_path)
        if n:
            return new
    return module_path


def _leaf(name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if name not in _LEAF_NAMES:  # raw parameters such as pos_bias_u keep their name
        return name, arr
    if name == "kernel":
        arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
    return _LEAF_NAMES[name], arr


def flax_to_state_dict(
    variables: Mapping[str, Any], renames=(), every=(), leaf=_leaf
) -> Dict[str, torch.Tensor]:
    """Generic converter: walks ``params`` and ``batch_stats``, renames each
    module path by the first match of ``renames``, then by every pattern
    of ``every`` in turn, and converts each leaf by its name (``leaf``).
    BatchNorm modules also get ``num_batches_tracked``, which
    ``load_state_dict`` expects."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            module = _rename("/".join(path[:-1]), renames)
            for pattern, repl in every:
                module = re.sub(pattern, repl, module)
            name, arr = leaf(path[-1], arr)
            key = ".".join(p for p in module.split("/") + [name] if p)
            sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
            if name == "running_mean":
                sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def fastspeech2_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """FastSpeech2 flax variables -> the port's (and the reference's) state_dict."""
    return flax_to_state_dict(variables, FASTSPEECH2_RENAMES)


def aligner_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Aligner flax variables (or the bare ``params`` tree that
    ``train_aligner`` returns) -> the port's state_dict. The flax names are
    the port's keys: ``embed``, ``conv{i}``, ``ln{i}``, ``alignment.t_conv1`` …"""
    if "params" not in variables:
        variables = {"params": variables}
    return flax_to_state_dict(variables)


def hifigan_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """HiFiGANGenerator flax variables -> the port's state_dict. The flax
    ConvTranspose kernel (transpose_kernel=True) is [k, out, in], so the
    same (2, 1, 0) transpose as a Conv gives torch's [in, out, k]."""
    return flax_to_state_dict(variables, HIFIGAN_RENAMES)


VALLE_RENAMES = (
    (r"^blocks_(\d+)/norm_attn(/emb)?$", r"blocks/\1/attn/norm\2"),
    (r"^blocks_(\d+)/attn/(to_qkv|to_out)$", r"blocks/\1/attn/block/\2"),
    (r"^blocks_(\d+)/norm_ffn(/emb)?$", r"blocks/\1/ffn/norm\2"),
    (r"^blocks_(\d+)/ffn_in$", r"blocks/\1/ffn/block/0"),
    (r"^blocks_(\d+)/ffn_out$", r"blocks/\1/ffn/block/3"),
)


def valle_state_dict_from_jax(variables: Mapping[str, Any], n_layers: int) -> Dict[str, torch.Tensor]:
    """VALL-E AR or NAR flax variables -> the port's (and the reference's)
    state_dict: the inverse of ``jatts_tpu.utils.torch_import.convert_valle``.
    The raw tables ``proms_emb``/``resps_emb`` become ``<name>.weight`` (the
    NAR's ``resps_emb`` holds its 7 levels and no stop row); ``sep`` keeps
    its name; an AdaLN's ``norm_attn/emb`` (``norm_ffn/emb``) becomes
    ``blocks.N.attn.norm.emb.weight`` (``ffn``). Raises unless every one of
    the ``n_layers`` blocks was found."""
    sd = flax_to_state_dict(variables, VALLE_RENAMES)
    for name in ("proms_emb", "resps_emb"):
        sd[f"{name}.weight"] = sd.pop(name)
    found = {int(k.split(".")[1]) for k in sd if k.startswith("blocks.")}
    if found != set(range(n_layers)):
        raise ValueError(f"expected blocks 0..{n_layers - 1}, found {sorted(found)}")
    return sd


_EST = "decoder/estimator"
_BLOCK = r"(down|mid|up)_resnet_(\d+)"
_TF = r"(down|mid|up)_tf_(\d+)_(\d+)"


def matcha_estimator_renames(n_channels: int):
    """The U-Net estimator's flax module paths -> the reference's (the
    Decoder of matchatts/decoder.py with diffusers' BasicTransformerBlock
    inside), for ``n_channels`` scales: the last down- and upsampling are
    plain convs (``down_blocks.{n-1}.2``, ``up_blocks.{n-1}.2``), the others
    wrap theirs (``.2.conv``; upsampling is a ConvTranspose)."""
    last = n_channels - 1
    return (
        (rf"^{_EST}/downsample_{last}$", f"{_EST}/down_blocks/{last}/2"),
        (rf"^{_EST}/upsample_{last}$", f"{_EST}/up_blocks/{last}/2"),
        (rf"^{_EST}/downsample_(\d+)$", rf"{_EST}/down_blocks/\1/2/conv"),
        (rf"^{_EST}/upsample_(\d+)$", rf"{_EST}/up_blocks/\1/2/conv"),
        (rf"^{_EST}/{_BLOCK}/(block[12])/conv$", rf"{_EST}/\1_blocks/\2/0/\3/block/0"),
        (rf"^{_EST}/{_BLOCK}/(block[12])/norm$", rf"{_EST}/\1_blocks/\2/0/\3/block/1"),
        (rf"^{_EST}/{_BLOCK}/mlp$", rf"{_EST}/\1_blocks/\2/0/mlp/1"),
        (rf"^{_EST}/{_BLOCK}/res_conv$", rf"{_EST}/\1_blocks/\2/0/res_conv"),
        (rf"^{_EST}/{_TF}/to_(q|k|v)$", rf"{_EST}/\1_blocks/\2/1/\3/attn1/to_\4"),
        (rf"^{_EST}/{_TF}/to_out$", rf"{_EST}/\1_blocks/\2/1/\3/attn1/to_out/0"),
        (rf"^{_EST}/{_TF}/ff/proj$", rf"{_EST}/\1_blocks/\2/1/\3/ff/net/0/proj"),
        (rf"^{_EST}/{_TF}/ff/out$", rf"{_EST}/\1_blocks/\2/1/\3/ff/net/2"),
        (rf"^{_EST}/{_TF}/ff$", rf"{_EST}/\1_blocks/\2/1/\3/ff/net/0"),  # alpha, beta
        (rf"^{_EST}/{_TF}/(norm[13])$", rf"{_EST}/\1_blocks/\2/1/\3/\4"),
        (rf"^{_EST}/final_block/conv$", rf"{_EST}/final_block/block/0"),
        (rf"^{_EST}/final_block/norm$", rf"{_EST}/final_block/block/1"),
    )


# flax's numbered submodules -> torch ModuleList indices: the WaveNets'
# layers, the flows, the text encoder's blocks, the stochastic duration
# predictor's convolutions and flows
LIST_RENAMES = (
    (r"(^|/)(conv_layers|flows|post_flows|encoders|dw|norm1|pw|norm2)_(\d+)(?=/|$)", r"\1\2/\3"),
)


def matchatts_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """MatchaTTS or MatchaTTS_MAS flax variables -> the port's (and the
    reference's) state_dict: the inverse of
    ``jatts_tpu.utils.torch_import.convert_matchatts`` and
    ``convert_matcha_estimator``. The encoder and the duration predictor
    are named as FastSpeech2's; ``alignment_module`` and ``projection`` keep
    their names; ConvTranspose kernels become ``[in, out, k]``; the
    stochastic duration predictor ``sdp`` gets the port's own keys
    (``modules/flows.py``)."""
    est = variables["params"]["decoder"]["estimator"]
    n = sum(1 for k in est if k.startswith("down_resnet_"))
    return flax_to_state_dict(variables, matcha_estimator_renames(n) + FASTSPEECH2_RENAMES, LIST_RENAMES)


def _wn_leaf(name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """WaveNet's weight-normed convolutions: v ``[k, in, out]`` -> weight_v
    ``[out, in, k]``, g ``[out]`` -> weight_g ``[out, 1, 1]``, b -> bias;
    every other leaf as ``_leaf``."""
    if name == "v":
        return "weight_v", np.transpose(arr, (2, 1, 0))
    if name == "g":
        return "weight_g", arr.reshape(-1, 1, 1)
    if name == "b":
        return "bias", arr
    return _leaf(name, arr)


def vits_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """VITS flax variables -> the port's state_dict: for the deterministic
    duration predictor the reference's keys, the inverse of
    ``jatts_tpu.utils.torch_import.convert_vits`` (couplings at
    ``flow.flows.{0,2,..}``, ``conv_layers.{i}`` with ``weight_g``/``weight_v``);
    the stochastic one's are the port's own (``modules/flows.py``)."""
    return flax_to_state_dict(variables, FASTSPEECH2_RENAMES, LIST_RENAMES, leaf=_wn_leaf)


E2TTS_RENAMES = (
    (r"^backbone/time_embed/mlp1$", "backbone/time_embed/time_mlp/0"),
    (r"^backbone/time_embed/mlp2$", "backbone/time_embed/time_mlp/2"),
    (r"^backbone/text_embed$", "backbone/text_embed/text_embed"),
    (r"^backbone/input_proj$", "backbone/input_embed/proj"),
    (r"^backbone/conv_pos_embed/conv1$", "backbone/input_embed/conv_pos_embed/conv1d/0"),
    (r"^backbone/conv_pos_embed/conv2$", "backbone/input_embed/conv_pos_embed/conv1d/2"),
    (r"^backbone/skip_proj_(\d+)$", r"backbone/layers/\1/0"),
    (r"^backbone/attn_norm_(\d+)$", r"backbone/layers/\1/1"),
    (r"^backbone/attn_(\d+)/to_out$", r"backbone/layers/\1/2/to_out/0"),
    (r"^backbone/attn_(\d+)/", r"backbone/layers/\1/2/"),
    (r"^backbone/ff_norm_(\d+)$", r"backbone/layers/\1/3"),
    (r"^backbone/ff_(\d+)/proj_in$", r"backbone/layers/\1/4/ff/0/0"),
    (r"^backbone/ff_(\d+)/proj_out$", r"backbone/layers/\1/4/ff/2"),
)


def e2tts_state_dict_from_jax(variables: Mapping[str, Any], depth: int) -> Dict[str, torch.Tensor]:
    """E2TTS flax variables -> the port's (and the reference's) state_dict:
    the inverse of ``jatts_tpu.utils.torch_import.convert_e2tts``. The
    RMSNorm scales keep the leaf name ``weight``; the grouped convolutions'
    kernels ``[k, C/groups, C]`` become ``[C, C/groups, k]``. Raises unless
    every one of the ``depth`` layers was found."""
    sd = flax_to_state_dict(variables, E2TTS_RENAMES)
    found = {int(k.split(".")[2]) for k in sd if k.startswith("backbone.layers.")}
    if found != set(range(depth)):
        raise ValueError(f"expected layers 0..{depth - 1}, found {sorted(found)}")
    return sd


ECAPA_EVERY = (
    (r"(^|/)blocks_(\d+)(?=/|$)", r"\1blocks/\2"),
    # speechbrain's wrappers: a Conv1d owns an inner .conv, a BatchNorm1d
    # an inner .norm
    (r"(^|/)(conv|conv1|conv2|fc)$", r"\1\2/conv"),
    (r"(^|/)(norm|asp_bn)$", r"\1\2/norm"),
)


def ecapa_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """ECAPA-TDNN flax variables (``jatts_tpu/features/ecapa.py``) -> the
    port's state_dict, which is speechbrain's ``embedding_model.ckpt``
    layout; the inverse of the JAX package's ``convert_speechbrain_ecapa``."""
    return flax_to_state_dict(variables, every=ECAPA_EVERY)
