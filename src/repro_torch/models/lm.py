"""Top-level LM: init / forward / loss / prefill / decode.

The port of `repro.models.lm` for the dense decoders, the configs whose
segments are [('attn_dense', n)] and which are not encoder-decoders:
qwen1.5-0.5b, qwen3-8b, yi-9b, chatglm3-6b and qwen2-vl-2b (its text path;
the vision frontend is a stub that feeds `embeds`).  MLA / MoE, SSM and
hybrid stacks, whisper's encoder-decoder and deepseek-v3's multi-token
prediction raise NotImplementedError naming their ROADMAP item.

`LM` holds the config and the device; params and caches are nested dicts
of tensors with the reference's keys, stacked (n_layers, ...) segment
leaves and its (d_in, ..., d_out) layouts, so `repro_torch.bridge` carries
a reference LM's params and AdamW state across unchanged.  Positions:
standard and rope2d take (B, S) int positions, mrope takes (3, B, S).
"""
from __future__ import annotations

from typing import Any

import torch

from . import layers, transformer as tfm
from .config import ModelConfig
from .transformer import segments


def unported(cfg: ModelConfig) -> str | None:
    """The ROADMAP item that ports `cfg`'s architecture, or None if the
    port runs it."""
    if cfg.enc_dec:
        return tfm.NOT_PORTED["dec_attn"]
    if cfg.hybrid_attn_every:
        return tfm.NOT_PORTED["mamba2"]
    if cfg.mtp_depth:
        return tfm.NOT_PORTED["mla_moe"]
    for kind, _ in segments(cfg):
        if kind != "attn_dense":
            return tfm.NOT_PORTED[kind]
    return None


class LM:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        item = unported(cfg)
        if item is not None:
            raise NotImplementedError(f"{cfg.name} is not ported yet: {item}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.segs = segments(cfg)
        self.dtype = getattr(torch, cfg.dtype)
        self._embed_lookup = (layers.embed_lookup_merged if cfg.dedup_embed_grad
                              else layers.embed_lookup_naive)

    # ---- params ----

    def init(self, generator: torch.Generator | None) -> dict:
        """Params drawn from `generator` (on its device), then put on the
        model's device.  generator=None gives the shapes alone on the meta
        device when the model's device is meta."""
        cfg, dtype = self.cfg, self.dtype
        dev = generator.device if generator is not None else self.device
        params: dict[str, Any] = {
            "embed": layers.normal_init(generator, (cfg.vocab, cfg.d_model), dtype=dtype,
                                        device=dev),
            "final_norm": tfm._init_norm(cfg, dtype, dev),
        }
        for i, (kind, n) in enumerate(self.segs):
            params[f"seg{i}_{kind}"] = tfm.init_segment(generator, cfg, kind, n, dtype, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.normal_init(generator, (cfg.d_model, cfg.vocab),
                                                   dtype=dtype, device=dev)
        return _to(params, self.device)

    # ---- positions ----

    def default_positions(self, batch: int, seq: int, offset: int = 0):
        pos = torch.arange(offset, offset + seq, dtype=torch.int32,
                           device=self.device)[None, :].repeat(batch, 1)
        if self.cfg.rope == "mrope":
            return pos[None].expand((3,) + tuple(pos.shape))   # degenerate text M-RoPE
        return pos

    # ---- embedding / head ----

    def embed(self, params, tokens):
        return self._embed_lookup(params["embed"], tokens).to(self.dtype)

    def logits(self, params, x):
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return (x @ head).to(torch.float32)

    # ---- forward (train / prefill logits) ----

    def _inputs(self, params, tokens, embeds):
        if embeds is not None:
            x = embeds.to(self.dtype)
        else:
            x = self.embed(params, tokens)
        return x, x.shape[0], x.shape[1]

    def forward(self, params, tokens=None, embeds=None, positions=None):
        """-> (logits (B, S, V) f32, final hidden states (B, S, D))."""
        x, b, s = self._inputs(params, tokens, embeds)
        if positions is None:
            positions = self.default_positions(b, s)
        for i, (kind, _) in enumerate(self.segs):
            x = tfm.apply_segment(params[f"seg{i}_{kind}"], self.cfg, kind, x, positions)
        h = tfm.apply_norm(self.cfg, params["final_norm"], x)
        return self.logits(params, h), h

    # ---- loss ----

    def loss(self, params, batch: dict) -> torch.Tensor:
        """batch: tokens (B, S), optionally embeds / positions.  Next-token
        cross-entropy, in f32."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, tokens=None if "embeds" in batch else tokens,
                                 embeds=batch.get("embeds"), positions=batch.get("positions"))
        targets = tokens[:, 1:]
        lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        nll = -torch.take_along_dim(lp, targets[..., None].to(torch.int64), dim=-1)[..., 0]
        return nll.mean()

    # ---- serving ----

    def init_caches(self, batch: int, max_seq: int) -> dict:
        caches: dict[str, Any] = {}
        for i, (kind, n) in enumerate(self.segs):
            one = tfm.init_block_cache(self.cfg, kind, batch, max_seq, self.dtype, self.device)
            caches[f"seg{i}_{kind}"] = tfm.stack_trees([one] * n)
        return caches

    def prefill(self, params, tokens=None, embeds=None, positions=None,
                max_seq: int | None = None):
        """Run the prompt: (last-token logits (B, V) f32, filled caches,
        None -- the encoder output an encoder-decoder would return).  The
        caches hold the prompt's keys and values as `decode_step` expects;
        decoding goes on at pos = prompt length.  Pass `max_seq` > the
        prompt length to leave room for generated tokens."""
        x, b, s = self._inputs(params, tokens, embeds)
        if positions is None:
            positions = self.default_positions(b, s)
        caches: dict[str, Any] = {}
        for i, (kind, _) in enumerate(self.segs):
            x, caches[f"seg{i}_{kind}"] = tfm.apply_segment_prefill(
                params[f"seg{i}_{kind}"], self.cfg, kind, x, positions, max_seq)
        h = tfm.apply_norm(self.cfg, params["final_norm"], x)
        return self.logits(params, h[:, -1:, :])[:, 0], caches, None

    def decode_step(self, params, caches, tokens, pos, encoder_out=None):
        """tokens (B, 1) int, pos (B, 1) absolute positions ->
        (logits (B, V) f32, new caches)."""
        if encoder_out is not None:
            raise NotImplementedError(f"encoder outputs: {tfm.NOT_PORTED['dec_attn']}")
        x = self.embed(params, tokens)
        rope_positions = None
        if self.cfg.rope == "mrope":
            rope_positions = pos[None].expand((3,) + tuple(pos.shape))
        new_caches = {}
        for i, (kind, _) in enumerate(self.segs):
            key = f"seg{i}_{kind}"
            x, new_caches[key] = tfm.apply_segment_decode(params[key], self.cfg, kind, x,
                                                          caches[key], pos, rope_positions)
        h = tfm.apply_norm(self.cfg, params["final_norm"], x)
        return self.logits(params, h)[:, 0], new_caches


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
