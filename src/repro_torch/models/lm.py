"""Top-level LM: init / forward / loss / prefill / decode.

The port of `repro.models.lm` for the decoders whose blocks are attention
(GQA or MLA) with a dense FFN or an MoE layer: qwen1.5-0.5b, qwen3-8b,
yi-9b, chatglm3-6b, qwen2-vl-2b (its text path; the vision frontend is a
stub that feeds `embeds`), deepseek-v2-lite and deepseek-v3 with its
depth-1 multi-token-prediction head (`mtp`: `loss` adds 0.3 times its
loss; its embedding call is a second `embed`); and for the SSM stacks:
falcon-mamba-7b (Mamba-1) and zamba2-7b (Mamba-2 with the weight-shared
attention block `params["shared_attn"]` every `hybrid_attn_every` layers,
whose caches are `caches["shared_attn"]`, stacked (n_groups, ...)); and
whisper-medium's encoder-decoder: `encode` runs the `enc_attn` stack
(`params["enc_segs"]`, `params["enc_norm"]`) over the frame embeddings the
audio stub feeds (`encoder_embeds`, (B, encoder_seq, D)), and each
`dec_attn` layer attends to its output.  Both stacks add sinusoidal
positions (`sinusoidal`, `sinusoidal_at`), cast to the model's dtype
before the add, as the reference adds them.  An encoder-decoder's
`forward`, `loss` and `prefill` need `encoder_embeds` (a ValueError
names it otherwise; the reference fails there on None), and `prefill`
returns the encoder output as its third value.

`LM` holds the config, the mesh and the device.  `mesh` (a
`launch.mesh.Mesh`, default None) reaches every block's `moe.moe_layer`,
as in the reference: on a mesh with more than one EP rank the MoE layers
run `moe.moe_ep`, every rank holding the whole batch and params and
getting the global gradients.  `tp_logits` and `act_spec` are the
reference's layout constraints, which `launch.steps` sets: on DTensor
activations (a placed step) `act_spec` (a `parallel.sharding.P` over the
(B, S, D) residual stream) re-lays x out after the embedding, after every
layer and after every segment of `forward` / `prefill` (without it a
DTensor stream goes back to its entering layout after every layer:
`_keeper`), and `tp_logits`
lays the logits out as P(dp, None, "model") when the vocab divides over
'model'.  Both are off by default, and on plain tensors neither does
anything.  `fsdp_axes` (mesh axes that split params for storage only,
the policy's FSDP axes) gathers each block's DTensor params over them
before the block runs, inside its remat, and the head before the logits
(ZeRO-3; `_gather_param`).
Params and caches are nested dicts
of tensors with the reference's keys, stacked (n_layers, ...) segment
leaves and its (d_in, ..., d_out) layouts, so `repro_torch.bridge` carries
a reference LM's params and AdamW state across unchanged.  Positions:
standard and rope2d take (B, S) int positions, mrope takes (3, B, S).
"""
from __future__ import annotations

from typing import Any

import torch

from . import layers, shards, transformer as tfm
from .config import ModelConfig
from .transformer import segments


def _sinusoid(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """pos (..., 1) f32 -> (..., d): sin then cos of pos / 10000^(2i/d),
    concatenated, computed in f32 and cast to `dtype`.  Each denominator is
    the f32 rounding of the f64 power, as XLA's f32 `power` gives it
    (torch's f32 `pow` is an ulp off at four of whisper's 512, which moves
    an angle at position 1500 by up to 3e-5)."""
    dim = torch.arange(d // 2, device=pos.device).to(torch.float32)
    ang = pos / torch.pow(10000.0, (2 * dim / d).to(torch.float64)).to(torch.float32)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoidal(seq: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The (seq, d) sinusoidal position table."""
    return _sinusoid(torch.arange(seq, device=device).to(torch.float32)[:, None], d, dtype)


def sinusoidal_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """The table's rows at positions pos (B, 1) -> (B, 1, d): the bytes of
    `sinusoidal(S, d, dtype)[pos]`."""
    return _sinusoid(pos[..., None].to(torch.float32), d, dtype)


class LM:
    def __init__(self, cfg: ModelConfig, mesh=None, device="cuda", tp_logits: bool = False,
                 act_spec=None, fsdp_axes=()):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        self.tp_logits = tp_logits
        self.act_spec = act_spec
        self.fsdp_axes = tuple(fsdp_axes)
        self._gather = self._gather_block if self.fsdp_axes else None
        self.segs = segments(cfg)
        self.dtype = getattr(torch, cfg.dtype)
        self._embed_lookup = (layers.embed_lookup_merged if cfg.dedup_embed_grad
                              else layers.embed_lookup_naive)

    def _relay(self, x, spec):
        """x laid out as `spec` says, when x is a DTensor on the mesh."""
        if self.mesh is None or getattr(x, "device_mesh", None) is None:
            return x
        from ..parallel.sharding import to_named
        return x.redistribute(x.device_mesh, to_named({"x": spec}, self.mesh)["x"])

    def _constrain(self, x):
        if self.act_spec is None or x.ndim != 3:
            return x
        return self._relay(x, self.act_spec)

    def _keeper(self, x):
        """What re-lays the residual stream out at each layer's end:
        `_constrain` under `act_spec`; a DTensor stream otherwise back to its
        layout entering the stack (a partial sum summed), so every layer
        runs the same program, as the reference's scan body does; the
        identity on plain tensors."""
        if self.act_spec is not None:
            return self._constrain
        if getattr(x, "device_mesh", None) is None:
            return tfm.identity
        from torch.distributed.tensor import Replicate
        placements = [Replicate() if p.is_partial() else p for p in x.placements]
        return lambda h: h.redistribute(h.device_mesh, placements)

    def _gather_param(self, t):
        """A DTensor param gathered over `fsdp_axes` (ZeRO-3's gather before
        its use), the other mesh axes' splits kept."""
        if not self.fsdp_axes or getattr(t, "device_mesh", None) is None:
            return t
        from torch.distributed.tensor import Replicate
        names = tuple(self.mesh.shape)
        pl = [Replicate() if names[i] in self.fsdp_axes else p for i, p in enumerate(t.placements)]
        return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)

    def _gather_block(self, params):
        """A block's params through `_gather_param`; the routed experts are
        left to the MoE layer, which gathers them over the axes that do not
        hold its experts."""
        from ..optim.adamw import tree_from_paths, tree_paths
        return tree_from_paths([
            (path, t if "moe" in path and path[-1] in ("w_gate", "w_up", "w_down")
             else self._gather_param(t)) for path, t in tree_paths(params)])

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
        if cfg.hybrid_attn_every:
            params["shared_attn"] = tfm.init_block(generator, cfg, "attn_dense", dtype, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.normal_init(generator, (cfg.d_model, cfg.vocab),
                                                   dtype=dtype, device=dev)
        if cfg.enc_dec:
            params["enc_segs"] = tfm.init_segment(generator, cfg, "enc_attn",
                                                  cfg.n_encoder_layers, dtype, dev)
            params["enc_norm"] = tfm._init_norm(cfg, dtype, dev)
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": layers.normal_init(generator, (2 * cfg.d_model, cfg.d_model),
                                           dtype=dtype, device=dev),
                "block": tfm.init_block(generator, cfg, self.segs[-1][0], dtype, dev),
                "norm_h": tfm._init_norm(cfg, dtype, dev),
                "norm_e": tfm._init_norm(cfg, dtype, dev),
            }
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
        """x (B, S, D) @ the head, f32; a DTensor x split along its sequence
        on each rank's tokens (`shards.tokens`).  One position (the last
        token's: `prefill`, `decode_step`) is a (B, D) product (matmul would
        expand the head to (B, D, V) for a strided x), on the head's own
        vocab split (`_head_rows`)."""
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        ranks = shards.tokens(x)
        if ranks is None and x.shape[1] == 1:
            out = self._head_rows(x[:, 0], head).to(torch.float32)[:, None]
        else:
            out = shards.leave(ranks, shards.mm(ranks, shards.enter(ranks, x),
                                                self._gather_param(head)).to(torch.float32))
        mesh = self.mesh
        if self.tp_logits and mesh is not None and "model" in mesh.shape \
                and self.cfg.vocab % mesh.shape["model"] == 0:
            from ..parallel.sharding import P
            dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
            out = self._relay(out, P(dp, None, "model"))
        return out

    def _head_rows(self, x, head):
        """x (B, D) @ the head (D, V).  A DTensor x is gathered over the mesh
        dims that split the head's vocab and meets the head's block there
        (B x D bytes moved where `_gather_param` would gather the D x V head:
        the head's FSDP split is its vocab's, `sharding.param_specs`)."""
        if getattr(x, "device_mesh", None) is None:
            return x @ head
        from torch.distributed.tensor import Replicate
        head = shards.as_dtensor(head, x.device_mesh)
        return shards.redistributed(x, x.device_mesh, [
            Replicate() if h.is_shard(1) else p for p, h in zip(x.placements, head.placements)
        ]) @ head

    # ---- encoder (whisper) ----

    def encode(self, params, encoder_embeds):
        """(B, S_enc, D) frame embeddings -> the encoder output (B, S_enc, D)."""
        cfg = self.cfg
        b, s, _ = encoder_embeds.shape
        x = encoder_embeds.to(self.dtype) + sinusoidal(s, cfg.d_model, self.dtype,
                                                       self.device)[None]
        x = tfm.apply_segment(params["enc_segs"], cfg, "enc_attn", x,
                              self.default_positions(b, s), mesh=self.mesh, gather=self._gather)
        return tfm.apply_norm(cfg, params["enc_norm"], x)

    # ---- forward (train / prefill logits) ----

    def _inputs(self, params, tokens, embeds, encoder_embeds):
        """(decoder input x, B, S, the encoder output or None)."""
        if embeds is not None:
            x = embeds.to(self.dtype)
        else:
            x = self.embed(params, tokens)
        b, s = x.shape[0], x.shape[1]
        if not self.cfg.enc_dec:
            return x, b, s, None
        if encoder_embeds is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: pass encoder_embeds "
                             f"(B, {self.cfg.encoder_seq}, {self.cfg.d_model})")
        x = x + sinusoidal(s, self.cfg.d_model, self.dtype, self.device)[None]
        return x, b, s, self.encode(params, encoder_embeds)

    def forward(self, params, tokens=None, embeds=None, positions=None, encoder_embeds=None):
        """-> (logits (B, S, V) f32, final hidden states (B, S, D))."""
        x, b, s, enc_out = self._inputs(params, tokens, embeds, encoder_embeds)
        if positions is None:
            positions = self.default_positions(b, s)
        keep = self._keeper(x)
        x = keep(x)
        for i, (kind, _) in enumerate(self.segs):
            seg = params[f"seg{i}_{kind}"]
            if self._hybrid(kind):
                x = tfm.apply_hybrid_segment(seg, self.cfg, kind, x, positions,
                                             params["shared_attn"], self.mesh, keep,
                                             self._gather)
            else:
                x = tfm.apply_segment(seg, self.cfg, kind, x, positions, enc_out, self.mesh,
                                      keep, self._gather)
            x = keep(x)
        h = tfm.apply_norm(self.cfg, params["final_norm"], x)
        return self.logits(params, h), h

    # ---- loss ----

    def loss(self, params, batch: dict) -> torch.Tensor:
        """batch: tokens (B, S), optionally embeds / positions /
        encoder_embeds.  Next-token cross-entropy, in f32; the MTP head adds
        deepseek-v3's auxiliary loss."""
        tokens = batch["tokens"]
        logits, h = self.forward(params, tokens=None if "embeds" in batch else tokens,
                                 embeds=batch.get("embeds"), positions=batch.get("positions"),
                                 encoder_embeds=batch.get("encoder_embeds"))
        loss = _next_token_nll(logits, tokens)
        if self.cfg.mtp_depth:
            loss = loss + 0.3 * self._mtp_loss(params, h, tokens)
        return loss

    def _mtp_loss(self, params, h, tokens):
        """Depth-1 multi-token prediction: from h_t and emb(t+1), predict
        t+2.  One block of the last segment's kind, without remat, at
        positions restarting from 0, on z (B, S - 1, D) laid out as the
        residual stream h is (`_mtp_inputs`).  The projection is gathered
        over the FSDP axes as a block's params are (split along its
        contracted dim, it would leave z a partial sum, which the block's
        first norm sums into the whole batch on every rank)."""
        cfg, mtp = self.cfg, params["mtp"]
        h_in, tok_next, ranks = _mtp_inputs(h, tokens)
        emb_next = self.embed(params, tok_next)                     # (B, S-1, D)
        x = torch.cat([tfm.apply_norm(cfg, mtp["norm_h"], h_in),
                       tfm.apply_norm(cfg, mtp["norm_e"], emb_next)], dim=-1)
        # with `ranks`, on each rank's own tokens, as the main stack's blocks;
        # z laid out as the stream before and after its block, as the main
        # stack's layers are (`_keeper`): the TP policy's proj splits z's D
        # over 'model', the block's row-parallel products leave partial sums
        keep = self._keeper(h)
        z = keep(shards.leave(ranks, shards.mm(ranks, shards.enter(ranks, x),
                                               self._gather_param(mtp["proj"]))))
        pos = self.default_positions(z.shape[0], z.shape[1])
        z = keep(tfm.apply_block(mtp["block"], cfg, self.segs[-1][0], z, pos, mesh=self.mesh,
                                 gather=self._gather))
        logits = self.logits(params, tfm.apply_norm(cfg, params["final_norm"], z))
        return _next_token_nll(logits, tok_next)

    # ---- serving ----

    def _hybrid(self, kind: str) -> bool:
        return bool(self.cfg.hybrid_attn_every) and kind in tfm.SSM_KINDS

    def init_caches(self, batch: int, max_seq: int) -> dict:
        cfg = self.cfg
        caches: dict[str, Any] = {}
        for i, (kind, n) in enumerate(self.segs):
            one = tfm.init_block_cache(cfg, kind, batch, max_seq, self.dtype, self.device)
            caches[f"seg{i}_{kind}"] = tfm.stack_trees([one] * n)
        if cfg.hybrid_attn_every:
            one = tfm.init_block_cache(cfg, "attn_dense", batch, max_seq, self.dtype, self.device)
            caches["shared_attn"] = tfm.stack_trees(
                [one] * (cfg.n_layers // cfg.hybrid_attn_every), one)
        return caches

    def prefill(self, params, tokens=None, embeds=None, positions=None, encoder_embeds=None,
                max_seq: int | None = None):
        """Run the prompt: (last-token logits (B, V) f32, filled caches, the
        encoder output of an encoder-decoder or None).  The caches hold the
        prompt's keys and values (and the encoder's, per decoder layer) as
        `decode_step` expects; decoding goes on at pos = prompt length.
        Pass `max_seq` > the prompt length to leave room for generated
        tokens."""
        x, b, s, enc_out = self._inputs(params, tokens, embeds, encoder_embeds)
        if positions is None:
            positions = self.default_positions(b, s)
        caches: dict[str, Any] = {}
        keep = self._keeper(x)
        for i, (kind, _) in enumerate(self.segs):
            key = f"seg{i}_{kind}"
            if self._hybrid(kind):
                x, caches[key], caches["shared_attn"] = tfm.apply_hybrid_segment_prefill(
                    params[key], self.cfg, kind, x, positions, params["shared_attn"], max_seq,
                    self.mesh, self._gather, keep)
            else:
                x, caches[key] = tfm.apply_segment_prefill(params[key], self.cfg, kind, x,
                                                           positions, max_seq, enc_out, self.mesh,
                                                           keep, self._gather)
        h = tfm.apply_norm(self.cfg, params["final_norm"], x)
        return self.logits(params, _last_token(h))[:, 0], caches, enc_out

    def decode_step(self, params, caches, tokens, pos, encoder_out=None):
        """tokens (B, 1) int, pos (B, 1) absolute positions ->
        (logits (B, V) f32, new caches).  `encoder_out` is accepted as the
        reference's is, and unread there too: the cross-attention reads the
        encoder's keys and values that `prefill` cached."""
        x = self.embed(params, tokens)
        if self.cfg.enc_dec:
            x = x + sinusoidal_at(pos, self.cfg.d_model, self.dtype)
        rope_positions = None
        if self.cfg.rope == "mrope":
            rope_positions = pos[None].expand((3,) + tuple(pos.shape))
        new_caches = {}
        keep = self._keeper(x)
        for i, (kind, _) in enumerate(self.segs):
            key = f"seg{i}_{kind}"
            if self._hybrid(kind):
                x, new_caches[key], new_caches["shared_attn"] = tfm.apply_hybrid_segment_decode(
                    params[key], self.cfg, kind, x, caches[key], pos, params["shared_attn"],
                    caches["shared_attn"], self.mesh, self._gather, keep)
            else:
                x, new_caches[key] = tfm.apply_segment_decode(params[key], self.cfg, kind, x,
                                                              caches[key], pos, rope_positions,
                                                              self.mesh, self._gather, keep)
        h = tfm.apply_norm(self.cfg, params["final_norm"], x)
        return self.logits(params, h)[:, 0], new_caches


def _mtp_inputs(h, tokens):
    """(h[:, :-1], tokens[:, 1:], the ranks of their blocks or None): a
    DTensor h split along its sequence (`shards.tokens`) gives both laid
    out along the stream's split, DTensor's uneven blocks of S - 1 (ceil-
    sized, the last one shorter): this rank's block of h[:, :-1] starts
    where its block of h does (the stream splits S evenly, so the ceil of
    (S - 1) / n is S / n), its tokens from the rows' whole token sequence."""
    ranks = shards.tokens(h)
    if ranks is None:
        return h[:, :-1], tokens[:, 1:], None
    from torch.distributed.tensor import Replicate
    b, s, d = h.shape
    (start, _), (z0, zl) = ranks.seq_block(s), ranks.seq_block(s - 1)
    if start != z0:
        raise ValueError(f"the MTP head: a stream of {s} tokens split unevenly {ranks.rows}")
    h_in = shards.from_local(ranks.enter(h)[:, :zl], ranks.mesh, ranks.rows, (b, s - 1, d))
    zr = shards.Ranks(h_in, tokens=True)
    rows = shards.as_dtensor(tokens, ranks.mesh).redistribute(
        ranks.mesh, [Replicate() if p.is_shard(1) else p for p in ranks.rows]).to_local()
    return h_in, zr.wrap(rows[:, z0 + 1:z0 + 1 + zl], zr.rows), zr


def _last_token(x):
    """x[:, -1:] of (B, S, D).  A DTensor x split along its sequence gives
    it from the block that holds the last position: every other block
    gives zeros, and the blocks are summed over the mesh dims that split
    the sequence (an all-reduce of (B, 1, D), where slicing the DTensor
    would gather the whole sequence first)."""
    ranks = shards.tokens(x)
    if ranks is None:
        return x[:, -1:]
    from torch.distributed.tensor import Partial, Replicate
    local = ranks.enter(x)
    last = local[:, -1:]
    if ranks.seq_offset(x.shape[1]) + local.shape[1] < x.shape[1]:
        last = torch.zeros_like(last)
    return ranks.leave(last, [Partial() if p.is_shard(1) else p for p in ranks.rows],
                       [Replicate() if p.is_shard(1) else p for p in ranks.rows])


def _next_token_nll(logits, tokens):
    """Mean cross-entropy of logits[:, :-1] (B, S, V) against tokens[:, 1:],
    in f32.  DTensor logits split over nothing but the batch and the
    sequence are scored on each rank's block (sliced as DTensors, the
    slice's backward would build the whole batch's logits gradient on every
    rank): split over the batch only, each block's mean weighted by its
    share of the rows; split along the sequence too, each block's sum over
    its positions that have a next token (their targets from the rows'
    whole token sequence) over the count of all of them.  The blocks' terms
    are summed over the mesh.  Logits split along the vocab too (the TP
    policy's, `tp_logits`) take `_vocab_parallel_nll`."""
    placements = getattr(logits, "placements", None)
    if placements is not None and any(p.is_shard(2) for p in placements) \
            and all(p.is_replicate() or p.is_shard() for p in placements):
        return _vocab_parallel_nll(logits, tokens)
    if placements is None or not all(p.is_replicate() or p.is_shard(0) or p.is_shard(1)
                                     for p in placements):
        return _nll(logits[:, :-1], tokens[:, 1:])
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    tokens = shards.as_dtensor(tokens, mesh)
    local = logits.to_local()
    b, s = logits.shape[0], logits.shape[1]
    if Shard(1) not in placements:
        rows = tokens.redistribute(mesh, placements).to_local()
        loss = _nll(local[:, :-1], rows[:, 1:])
        if local.shape[0] != b:
            loss = loss * (local.shape[0] / b)
    else:
        ranks = shards.Ranks(logits, tokens=True)
        rows = tokens.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                          for p in placements]).to_local()
        start = ranks.seq_offset(s)
        n = max(0, min(local.shape[1], s - 1 - start))
        loss = _token_nll(local[:, :n], rows[:, start + 1:start + 1 + n]).sum() / (b * (s - 1))
    loss = DTensor.from_local(loss, mesh, [Partial() if p.is_shard() else p for p in placements],
                              run_check=False)
    return loss.redistribute(mesh, [Replicate()] * mesh.ndim)


def _vocab_parallel_nll(logits, tokens):
    """`_next_token_nll` of DTensor logits split along the vocab (Shard(2)),
    and along the batch and the sequence or not, on each rank's block
    (B_l, S_l, V_l) as Megatron's cross-entropy computes it: each position's
    max, sum of exponentials and target logit all-reduced over the mesh dims
    that split the vocab (`_VocabParallelNLL`), so no rank holds more than
    its block of the logits or of their gradient.  Each block's sum over
    its positions that have a next token over the count of all of them;
    summed over the batch and sequence dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, placements = logits.device_mesh, list(logits.placements)
    b, s, v = logits.shape
    rows = shards.as_dtensor(tokens, mesh).redistribute(
        mesh, [p if p.is_shard(0) else Replicate() for p in placements]).to_local()
    s0, sl = shards.chunk(s, mesh, placements, 1)
    v0, _ = shards.chunk(v, mesh, placements, 2)
    targets = torch.roll(rows, -1, 1)[:, s0:s0 + sl].to(torch.int64) - v0
    groups = [mesh.get_group(i) for i, p in enumerate(placements) if p.is_shard(2)]
    nll = _VocabParallelNLL.apply(logits.to_local(), targets, groups)
    n = max(0, min(sl, s - 1 - s0))
    loss = DTensor.from_local(nll[:, :n].sum() / (b * (s - 1)), mesh,
                              [Replicate() if p.is_shard(2) or p.is_replicate() else Partial()
                               for p in placements], run_check=False)
    return loss.redistribute(mesh, [Replicate()] * mesh.ndim)


class _VocabParallelNLL(torch.autograd.Function):
    """Each position's cross-entropy (B, S) of a vocab block (B, S, V_l) of
    logits against targets offset to the block (outside [0, V_l): another
    block's), the block's max, sum of exponentials and target logit
    all-reduced over `groups`; the backward (softmax - onehot) x the
    gradient on the block alone."""

    @staticmethod
    def forward(ctx, block, targets, groups):
        import torch.distributed._functional_collectives as funcol

        def over_vocab(t, op):
            for g in groups:
                t = funcol.all_reduce(t, op, g)
                if isinstance(t, funcol.AsyncCollectiveTensor):     # eager: wait for it
                    t = t.wait()
            return t

        x = block.to(torch.float32)
        top = over_vocab(x.amax(dim=-1), "max")
        e = (x - top[..., None]).exp_()
        total = over_vocab(e.sum(dim=-1), "sum")
        inside = (targets >= 0) & (targets < x.shape[-1])
        at = targets.clamp(0, x.shape[-1] - 1)[..., None]
        hit = over_vocab(torch.where(inside, torch.take_along_dim(x, at, dim=-1)[..., 0], 0.0),
                         "sum")
        ctx.save_for_backward(e, total, at, inside)
        return total.log() + top - hit

    @staticmethod
    def backward(ctx, grad):
        e, total, at, inside = ctx.saved_tensors
        d = e * (grad / total)[..., None]
        d.scatter_add_(-1, at, -torch.where(inside, grad, 0.0)[..., None])
        return d, None, None


def _token_nll(logits, targets):
    """Each token's cross-entropy of (B, S, V) logits against targets, f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.take_along_dim(lp, targets[..., None].to(torch.int64), dim=-1)[..., 0]


def _nll(logits, targets):
    """Mean next-token cross-entropy of (B, S, V) logits, in f32."""
    return _token_nll(logits, targets).mean()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
