"""E2-TTS, the non-autoregressive flow-matching infill model (counterpart
of jatts_tpu/models/e2tts.py).

``forward`` is the training call (the JAX ``__call__``): a random span of
each utterance (0.7-1.0 of its frames) is hidden from the condition,
``phi_t = (1 - t)·x0 + t·x1`` is fed to the :class:`UNetT` backbone with
per-sample classifier-free-guidance drops (audio 0.3, both 0.2), and the
loss is the MSE of the predicted flow over the span. ``inference`` runs the
Euler ODE with sway-sampled timesteps and classifier-free guidance as one
doubled-batch forward a step, the text embedding computed once before the
loop. Parameters carry the reference state_dict keys under ``backbone.``,
so ``jatts_tpu.utils.torch_import.convert_e2tts`` reads ``state_dict()`` as
it stands; ``dtype`` is the compute dtype (parameters stay float32, the
flow is float32), see ``modules/e2tts_backbone.py``.

Every random draw goes through the module-level :func:`draw`: in training
from ``noise_generator`` (the trainer's noise stream, ``modules/noise.py``),
so a resumed run draws what an uninterrupted one would; in inference from
the caller's ``generator``. Under a mesh (``parallel/mesh.py``) the
training draws are made at the global batch's shape and each rank keeps its
rows (and, under sequence parallelism, its frames), and the loss is this
rank's sum over the world's count. With ``seq_parallel`` the model rank
holds a block of the frames (``UNetT.forward``). ``use_remat`` and
``remat_policy`` go to the backbone, which recomputes each attention and
feed-forward call in the backward; the span, noise, time and CFG draws are
made here, outside the recomputed calls, once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from jatts_torch.device import resolve_device
from jatts_torch.modules.e2tts_backbone import UNetT
from jatts_torch.ops.masks import sequence_mask
from jatts_torch.parallel.mesh import active, global_sum


def draw(kind: str, shape, generator: Optional[torch.Generator], device, low: float = 0.0,
         high: float = 1.0) -> torch.Tensor:
    """One float32 draw from ``generator``: ``normal`` N(0, 1), or
    ``uniform`` on [low, high) (``u·(high - low) + low``, at least ``low``,
    as ``jax.random.uniform`` scales its draws)."""
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u * (high - low) + low, min=low)


def mask_from_frac_lengths(seq_len: torch.Tensor, frac_min: float, frac_max: float, t_max: int,
                           generator: Optional[torch.Generator] = None, rows=None) -> torch.Tensor:
    """A random contiguous span of ``frac`` ~ U[frac_min, frac_max) of each
    utterance's frames: [B, t_max] bool. ``frac·seq_len`` and
    ``(seq_len - length)·u`` are taken in float32 before the integer cast,
    so the spans are the JAX package's integers for the same draws. Under a
    mesh, ``rows`` is the mesh: the uniforms are drawn for the global batch
    and cut to its rows."""
    shape = (seq_len.shape[0] * (rows.n_data if rows is not None else 1),)
    take = rows.rows if rows is not None else (lambda x: x)
    frac = take(draw("uniform", shape, generator, seq_len.device, frac_min, frac_max))
    lengths = (frac * seq_len.float()).int()
    max_start = seq_len.int() - lengths
    start = (max_start.float() * take(draw("uniform", shape, generator, seq_len.device))).int().clamp(min=0)
    end = start + lengths
    pos = torch.arange(t_max, device=seq_len.device)[None, :]
    return (pos >= start[:, None]) & (pos < end[:, None])


class E2TTS(nn.Module):
    samples_noise = True  # inference draws its initial noise: callers hand in a generator
    supports_seq_parallel = True  # the trainer may cut its frames over the mesh's model axis

    def __init__(
        self,
        idim: int,
        odim: int = 80,
        backbone: str = "UNetT",
        dim: int = 1024,
        depth: int = 24,
        heads: int = 16,
        ff_mult: int = 4,
        text_mask_padding: bool = False,
        pe_attn_head: Optional[int] = 1,
        sigma: float = 0.0,
        audio_drop_prob: float = 0.3,
        cond_drop_prob: float = 0.2,
        frac_lengths_mask: Sequence[float] = (0.7, 1.0),
        attn_backend: str = "xla",
        use_remat: bool = False,
        remat_policy: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if backbone != "UNetT":
            raise ValueError(f"Unsupported backbone: {backbone}")
        del sigma  # unused, as in the JAX model
        dev = resolve_device(device)
        self.odim = odim
        self.audio_drop_prob = audio_drop_prob
        self.cond_drop_prob = cond_drop_prob
        self.frac_lengths_mask = tuple(frac_lengths_mask)
        self.dtype = dtype
        self.noise_generator: Optional[torch.Generator] = None
        self.backbone = UNetT(
            text_num_embeds=idim, mel_dim=odim, dim=dim, depth=depth, heads=heads, ff_mult=ff_mult,
            text_mask_padding=text_mask_padding, pe_attn_head=pe_attn_head, attn_backend=attn_backend,
            compute_dtype=dtype, use_remat=use_remat, remat_policy=remat_policy, device=dev,
        )

    def forward(self, text: torch.Tensor, feats: torch.Tensor, feats_lengths: torch.Tensor,
                seq_parallel: bool = False) -> Dict[str, torch.Tensor]:
        """Training: text [B, N_t] ids (pad -1), feats [B, N, odim], lengths
        [B] -> {"loss", "cond", "pred"}. The draws, in the JAX model's order:
        the span (two uniforms), x0, t, the audio and the both-drop flags.
        With ``seq_parallel`` (under a mesh) feats are this model rank's
        block of the frames, text and lengths whole; cond and pred are the
        block's."""
        g = self.noise_generator
        m = active()
        b, n, _ = feats.shape
        dev = feats.device
        bg = b * (m.n_data if m is not None else 1)
        n_all = n * m.n_model if seq_parallel else n

        def rows(x):
            return x if m is None else m.rows(x)

        def frames(x):
            return m.frames(x) if seq_parallel else x

        span = frames(mask_from_frac_lengths(feats_lengths, *self.frac_lengths_mask, n_all, generator=g, rows=m))
        x1 = feats.float()
        x0 = frames(rows(draw("normal", (bg, n_all, x1.shape[2]), g, dev)))
        time = rows(draw("uniform", (bg,), g, dev))
        t = time[:, None, None]
        phi = (1.0 - t) * x0 + t * x1
        flow = x1 - x0
        cond = x1.masked_fill(span[..., None], 0.0)
        drop_audio = rows(draw("uniform", (bg,), g, dev)) < self.audio_drop_prob
        drop_both = rows(draw("uniform", (bg,), g, dev)) < self.cond_drop_prob
        drop_audio = drop_audio | drop_both
        mask = sequence_mask(feats_lengths, n_all)
        pred = self.backbone(phi, cond, text, time, drop_audio, drop_both, mask, seq_parallel=seq_parallel)
        err = (pred - flow) ** 2
        sel = span[..., None].to(err.dtype)
        loss = (err * sel).sum() / torch.clamp(global_sum(sel.sum()) * self.odim, min=1.0)
        return {"loss": loss, "cond": cond, "pred": pred}

    @torch.no_grad()
    def inference(
        self,
        cond: torch.Tensor,
        text: torch.Tensor,
        ref_lens: torch.Tensor,
        duration: torch.Tensor,
        steps: int = 32,
        cfg_strength: float = 1.0,
        sway_sampling_coef: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Euler ODE from noise drawn from ``generator``: cond [B, T_max,
        odim] the (normalised) prompt mel, zero-padded, ``T_max`` the static
        capacity; text [B, N_t] ids of prompt and target (pad -1); ref_lens
        [B] prompt frames; duration [B] total frames, clipped to [1, T_max].
        With ``cfg_strength`` >= 1e-5 each step is one forward over
        ``[cond; uncond]`` and ``pred + (pred - null)·cfg_strength``. Returns
        ``feat_gen`` [B, T_max, odim] (the prompt frames kept, zero past
        ``duration``) and ``olens`` (the clipped durations). Runs in eval
        mode; the mode is restored. It is :meth:`inference_start`, ``steps``
        :meth:`inference_step` calls and :meth:`inference_finish`, the three
        parts a serving artifact exports."""
        was_training = self.training
        self.eval()
        try:
            state = self.inference_start(cond, text, ref_lens, duration, steps, cfg_strength, sway_sampling_coef,
                                         generator)
            for i in range(steps):
                state["y"] = self.inference_step(state, i, cfg_strength)
            return self.inference_finish(state)
        finally:
            self.train(was_training)

    def inference_start(self, cond, text, ref_lens, duration, steps: int = 32, cfg_strength: float = 1.0,
                        sway_sampling_coef: Optional[float] = None,
                        generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """:meth:`inference`'s state before its first step: the noise drawn,
        the times ``ts`` [steps + 1], the rows (doubled under CFG), their
        masks and drops and the text embedding. The model must be in eval
        mode."""
        net = self.backbone
        b, t_max, _ = cond.shape
        dev = cond.device
        duration = torch.clamp(duration, 1, t_max)
        cond_mask = sequence_mask(ref_lens, t_max)[..., None]
        step_cond = cond.masked_fill(~cond_mask, 0.0)
        mask = sequence_mask(duration, t_max)
        y = draw("normal", (b, t_max, self.odim), generator, dev).to(cond.dtype)
        ts = torch.linspace(0.0, 1.0, steps + 1, dtype=torch.float32, device=dev)
        if sway_sampling_coef is not None:
            ts = ts + sway_sampling_coef * (torch.cos(torch.pi / 2 * ts) - 1 + ts)
        # guided: rows [cond; uncond], the second half with the audio
        # and the text dropped
        drop = torch.zeros(b, dtype=torch.bool, device=dev)
        if cfg_strength >= 1e-5:
            step_cond, text, mask = (torch.cat([x, x]) for x in (step_cond, text, mask))
            drop = torch.cat([drop, ~drop])
        rows = step_cond.shape[0]
        te = net(step_cond, step_cond, text, torch.zeros(rows, device=dev), drop, drop, mask,
                 return_text_embed=True)
        return {"cond": cond, "cond_mask": cond_mask, "duration": duration, "y": y, "ts": ts,
                "step_cond": step_cond, "text": text, "mask": mask, "drop": drop, "text_embed": te}

    def inference_step(self, state: Dict[str, torch.Tensor], i, cfg_strength: float = 1.0) -> torch.Tensor:
        """Euler step ``i`` (an int, or an int64 0-d tensor on the device)
        from ``state["y"]``: the next y."""
        ts, y, guided = state["ts"], state["y"], cfg_strength >= 1e-5
        b, rows = y.shape[0], state["step_cond"].shape[0]
        if isinstance(i, torch.Tensor):  # gathered on the device: no host read of i
            t_i, t_next = ts.index_select(0, torch.stack([i, i + 1]))
        else:
            t_i, t_next = ts[i], ts[i + 1]
        dt = t_next - t_i
        out = self.backbone(torch.cat([y, y]) if guided else y, state["step_cond"], state["text"], t_i.expand(rows),
                            state["drop"], state["drop"], state["mask"], text_embed=state["text_embed"])
        if guided:
            pred, null = out[:b], out[b:]
            out = pred + (pred - null) * cfg_strength
        return y + dt * out

    def inference_finish(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """:meth:`inference`'s output from the state after its last step."""
        b = state["y"].shape[0]
        mask = state["mask"][:b]
        out = torch.where(state["cond_mask"], state["cond"], state["y"]) * mask[..., None]
        return {"feat_gen": out, "olens": state["duration"]}
