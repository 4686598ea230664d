"""Decoder-only LM of the port: the ``uniform``, ``local_global``,
``zamba`` and ``rwkv`` families.

Counterpart of ``repro.models.transformer.LM``. The layers are an
``nn.ModuleList`` walked by a Python loop where JAX scans a stacked
parameter tree:

* uniform: ``layers.<i>.attn.*`` and ``layers.<i>.mlp.*``, or
  ``layers.<i>.moe.*`` when the config has experts; the first
  ``first_k_dense`` layers are JAX's ``head_layers`` (a dense MLP of
  ``top_k * d_ff`` in an MoE stack), the rest its ``blocks``
  (deepseek-7b, deepseek-67b, granite-moe-3b-a800m,
  moonshot-v1-16b-a3b, and qwen2-vl-2b with M-RoPE and musicgen-large,
  whose modality frontends are ``models.frontends``);
* local_global: ``layers.<i>.attn.*`` and ``layers.<i>.mlp.*`` in JAX's
  order: groups of ``local_global_ratio`` = R local layers (a sliding
  window of ``local_window``) then one global layer, layer ``g (R + 1) +
  R`` the global one of group g, then ``tail`` local layers (gemma3-12b,
  gemma3-27b);
* zamba: ``layers.<i>.*`` Mamba2 layers, the JAX ``blocks`` (G, every)
  stack then the ``tail``, and one weight-shared ``shared_attn`` /
  ``shared_mlp`` block applied after each group of ``every`` layers
  (zamba2-1.2b);
* rwkv: ``layers.<i>.*`` RWKV6 layers (rwkv6-1.6b).

``prefill`` returns the port's own cache, preallocated (``new_cache``, or
the caller's, as the serving engine's slots pass theirs) and written in
place by ``decode_step`` (replacing ``_pad_cache``): uniform
``{"k", "v"}`` of (L, B, KV, max_len, hd) over head and body layers
together (JAX keeps ``cache["head"]`` and ``cache["body"]``);
local_global ``{"k", "v"}`` of (G, B, KV, max_len, hd) for the G global
layers beside rings ``{"k_win", "v_win"}`` of (L - G, B, KV, W, hd) for
the local layers in order, W = min(local_window, max_len) as in JAX's
``cache_specs``; zamba ``{"ssm_h"}`` of (L, B, nh, hd, ds) f32 beside
``{"k", "v"}`` of (G, B, KV, max_len, hd) for the shared block's G
applications; rwkv ``{"S", "x_tm", "x_cm"}`` as JAX's (L, B, ...) f32.

A ring holds position p at slot p % W: ``prefill`` writes the last
min(S, W) keys there and ``decode_step`` the new one. JAX's
``clip_window`` stores the last W keys at slots 0..W-1 instead, which is
the same layout only when S <= W or S % W == 0; after other prompts its
decode overwrites a key still inside the window. The port follows the
model's definition, JAX's ``logits_train`` (ROADMAP.md, the note on the
reference).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.sharding import TensorSpec
from ..kernels import ops
from .layers import (MATMUL, MLP, Attention, MoE, _param, attention, mlp,
                     moe, rmsnorm)
from .rwkv import RWKV, rwkv_block, rwkv_dims
from .ssm import SSM, ssm_block, ssm_decode, ssm_dims


CE_CHUNK = 256            # positions a chunk of the cross-entropy


def ce_chunk(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
             z_loss: float) -> torch.Tensor:
    """Summed CE plus z-loss of one chunk: f32 logits ``h @ head``
    (B, cs, V), ``sum(lse - logit[target]) + z_loss * sum(lse^2)``."""
    logits = h.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - tgt).sum() + z_loss * torch.square(lse).sum()


def family_kind(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.family == "hybrid":
        return "zamba"
    if cfg.local_global_ratio > 0:
        return "local_global"
    return "uniform"


def zamba_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(#groups of ``shared_attn_every`` SSM layers, #tail SSM layers)."""
    every = cfg.shared_attn_every or cfg.n_layers + 1
    return divmod(cfg.n_layers, every)


def lg_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(#groups of R local + 1 global layers, #tail local layers)."""
    return divmod(cfg.n_layers, cfg.local_global_ratio + 1)


def lg_layers(cfg: ModelConfig) -> list[tuple[bool, int]]:
    """local_global: (global?, its index among the global or among the
    local layers) of each layer, in JAX's order."""
    R = cfg.local_global_ratio
    G, _ = lg_groups(cfg)
    out, n = [], [0, 0]
    for i in range(cfg.n_layers):
        glob = i < G * (R + 1) and i % (R + 1) == R
        out.append((glob, n[glob]))
        n[glob] += 1
    return out


def check_supported(cfg: ModelConfig) -> None:
    """Refuses a config the model cannot run: a local_global stack
    without a window, a negative logit cap."""
    if family_kind(cfg) == "local_global" and cfg.local_window <= 0:
        raise ValueError(f"{cfg.name}: local_global needs local_window > 0")
    if cfg.attn_logit_softcap < 0:
        raise ValueError(f"{cfg.name}: attn_logit_softcap must be >= 0")


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> dict[str, TensorSpec]:
    """The decode cache of :meth:`LM.new_cache` described without storage:
    each leaf's shape, dtype (KV in the compute ``dtype``, states f32) and
    the logical axes of JAX's ``cache_specs``
    (``src/repro/models/transformer.py:126``), the layer axes first and
    replicated. The leaves are the port's layout (module docstring); the
    bytes are JAX's at a bf16 ``dtype``, its caches' dtype."""
    kind = family_kind(cfg)
    kv_axes = (None, "batch", "kv_heads", "kv_seq", None)
    if kind == "rwkv":
        nh, hd = rwkv_dims(cfg)
        L, d = cfg.n_layers, cfg.d_model
        x = TensorSpec((L, batch, d), (None, "batch", None))
        return {"S": TensorSpec((L, batch, nh, hd, hd),
                                (None, "batch", None, None, None)),
                "x_tm": x, "x_cm": x}
    n = {"uniform": cfg.n_layers, "local_global": lg_groups(cfg)[0],
         "zamba": zamba_groups(cfg)[0]}[kind]
    kv = TensorSpec((n, batch, cfg.n_kv_heads, max_len, cfg.hd), kv_axes,
                    dtype)
    out = {"k": kv, "v": kv}
    if kind == "local_global":
        ring = TensorSpec((cfg.n_layers - n, batch, cfg.n_kv_heads,
                           min(cfg.local_window, max_len), cfg.hd), kv_axes,
                          dtype)
        out.update(k_win=ring, v_win=ring)
    if kind == "zamba":
        _, nh, hd, ds = ssm_dims(cfg)
        out["ssm_h"] = TensorSpec((cfg.n_layers, batch, nh, hd, ds),
                                  (None, "batch", None, None, None))
    return out


def d_ff_head(cfg: ModelConfig) -> int:
    """Width of the dense MLP of the ``first_k_dense`` head layers."""
    return cfg.top_k * cfg.d_ff if cfg.n_experts else cfg.d_ff


class Block(nn.Module):
    """One uniform layer: attention, then a dense MLP (``head``: one of
    the ``first_k_dense`` layers, or a config without experts) or MoE."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, head: bool):
        super().__init__()
        self.attn = Attention(cfg, device=device, dtype=dtype)
        if head or not cfg.n_experts:
            self.mlp = MLP(cfg, device=device, dtype=dtype,
                           d_ff=d_ff_head(cfg) if head else None)
        else:
            self.moe = MoE(cfg, device=device, dtype=dtype)

    @property
    def ffn(self):
        return self.moe if hasattr(self, "moe") else self.mlp


class LM(nn.Module):
    """Parameters: ``embed`` (V, d), ``final_norm`` (d,) and ``lm_head``
    (d, V) in f32, as JAX reads them; the family's layers (module
    docstring) with matmul weights in ``param_dtype`` (default: the
    compute ``dtype``; f32 masters for training, cast to ``dtype`` on
    use) and every other leaf in f32.

    ``device=None`` means the card (and raises without one). ``kernels``
    is the namespace of the hot operations: :mod:`..kernels.ops`
    (default) or :mod:`..kernels.plain`.
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16, kernels=ops,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.kind = family_kind(cfg)
        self.dtype = dtype
        self.kernels = kernels
        dtype = param_dtype or dtype          # the matmul weights' storage
        self.embed = _param((cfg.vocab, cfg.d_model), torch.float32, dev)
        self.final_norm = _param((cfg.d_model,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), torch.float32,
                                  dev)
        if self.kind in ("uniform", "local_global"):
            self.layers = nn.ModuleList(
                Block(cfg, device=dev, dtype=dtype, head=i < cfg.first_k_dense)
                for i in range(cfg.n_layers))
        else:
            layer = {"zamba": SSM, "rwkv": RWKV}[self.kind]
            self.layers = nn.ModuleList(layer(cfg, device=dev, dtype=dtype)
                                        for _ in range(cfg.n_layers))
        if self.kind == "zamba":
            self.shared_attn = Attention(cfg, device=dev, dtype=dtype)
            self.shared_mlp = MLP(cfg, device=dev, dtype=dtype)

    @classmethod
    def from_params(cls, cfg: ModelConfig, params: dict, *,
                    kernels=ops, dtype: Optional[torch.dtype] = None
                    ) -> "LM":
        """Wrap a parameter dict (``repro_torch.params``) without copying
        it; the device is the parameters' own, the compute ``dtype`` by
        default the dtype the matmul weights are stored in (f32 masters
        with a bf16 ``dtype``: the training layout)."""
        stored = next(t.dtype for n, t in params.items()
                      if n.rsplit(".", 1)[-1] in MATMUL)
        device = params["embed"].device
        lm = cls(cfg, device="meta", dtype=dtype or stored, kernels=kernels,
                 param_dtype=stored)
        expected = {n: (p.shape, p.dtype) for n, p in lm.named_parameters()}
        if set(params) != set(expected):
            raise ValueError(
                f"parameter names differ: missing "
                f"{sorted(set(expected) - set(params))}, unexpected "
                f"{sorted(set(params) - set(expected))}")
        for name, t in params.items():
            if (t.shape, t.dtype) != expected[name] or t.device != device:
                raise ValueError(
                    f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                    f"expected {tuple(expected[name][0])} "
                    f"{expected[name][1]} on {device}")
        lm.load_state_dict(params, strict=True, assign=True)
        return lm

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- embeddings -----------------------------------------------------
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """``LM.embed`` of the JAX model: scaled by sqrt(d_model) in f32,
        then cast to the compute dtype. ``F.embedding``: its backward on
        the card is reproducible bit for bit, which the train phase's
        remat and resume checks hold."""
        x = F.embedding(tokens, self.embed) * math.sqrt(self.cfg.d_model)
        return x.to(self.dtype)

    def embed_vectors(self, embeds: torch.Tensor) -> torch.Tensor:
        """``LM.embed_vectors``: a modality frontend's embeddings (B, S,
        d) cast to the compute dtype, unscaled."""
        return embeds.to(self.dtype)

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return h.to(torch.float32) @ head.to(torch.float32)

    # -- one attention + mlp / moe layer ----------------------------------
    def _layer(self, attn: Attention, ffn: Union[MLP, MoE], x, positions, *,
               window=0, cache=None, cache_pos=None, update_cache=False,
               aux=False):
        """Returns (x, this layer's k/v or None, and with ``aux`` its MoE
        load-balance loss, else None)."""
        a, new_kv = attention(attn, x, self.cfg, positions=positions,
                              window=window, cache=cache,
                              cache_pos=cache_pos,
                              update_cache=update_cache,
                              kernels=self.kernels)
        x = x + a
        lb = None
        if isinstance(ffn, MoE):
            y, lb = moe(ffn, x, self.cfg, kernels=self.kernels, aux=aux)
            x = x + y
        else:
            x = x + mlp(ffn, x, self.cfg, kernels=self.kernels)
        return x, new_kv, lb

    def _final_norm(self, x):
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps,
                       kernels=self.kernels)

    def _lg(self):
        """local_global: (global?, index, window) of each layer."""
        return [(glob, j, 0 if glob else self.cfg.local_window)
                for glob, j in lg_layers(self.cfg)]

    def _shared_after(self, i: int) -> Optional[int]:
        """zamba: the shared block's application index after SSM layer
        ``i``, or None."""
        G, _ = zamba_groups(self.cfg)
        every = self.cfg.shared_attn_every
        if self.kind == "zamba" and i < G * every and (i + 1) % every == 0:
            return i // every
        return None

    # ======================== TRAIN =====================================
    def hidden_train(self, x: torch.Tensor, positions: torch.Tensor,
                     remat: bool = True):
        """``LM.hidden_train``: the layer walk over x (B, S, d) in the
        compute dtype. With ``remat`` each layer (the zamba shared block
        apart from its SSM layers) runs under ``torch.utils.checkpoint``,
        as JAX wraps each scanned block in ``jax.checkpoint``: its
        activations are recomputed in the backward. Returns the
        final-normed h and the summed MoE load-balance loss (0.0 without
        experts)."""
        cfg = self.cfg

        def run(fn, *args):
            if remat and torch.is_grad_enabled():
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        aux = 0.0
        lg = self._lg() if self.kind == "local_global" else None
        for i, layer in enumerate(self.layers):
            if self.kind in ("uniform", "local_global"):
                window = lg[i][2] if lg else 0
                moe_layer = isinstance(layer.ffn, MoE)

                def body(xc, layer=layer, window=window, moe_layer=moe_layer):
                    xc, _, lb = self._layer(layer.attn, layer.ffn, xc,
                                            positions, window=window,
                                            aux=moe_layer)
                    return (xc, lb) if moe_layer else xc
                if moe_layer:
                    x, lb = run(body, x)
                    aux = aux + lb
                else:
                    x = run(body, x)
            elif self.kind == "zamba":
                x = run(lambda xc, layer=layer: xc + ssm_block(
                    layer, xc, cfg, kernels=self.kernels)[0], x)
                if self._shared_after(i) is not None:
                    x = run(lambda xc: self._layer(
                        self.shared_attn, self.shared_mlp, xc, positions)[0],
                        x)
            else:
                x = run(lambda xc, layer=layer: rwkv_block(
                    layer, xc, cfg, kernels=self.kernels)[0], x)
        return self._final_norm(x), aux

    def logits_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full logits (B, S, V) in f32 — small inputs only (tests)."""
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        h, _ = self.hidden_train(x, positions, remat=False)
        return self.unembed(h)

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             z_loss: float = 1e-4, embeds: Optional[torch.Tensor] = None,
             remat: bool = True) -> torch.Tensor:
        """``LM.loss``: mean cross-entropy of ``targets`` (B, S) over
        chunks of ``CE_CHUNK`` positions (f32 logits ``h @ head``, their
        logsumexp, plus ``z_loss * lse^2``), divided by B * n_chunk * cs,
        plus ``0.01 * aux / n_layers`` for a config with experts. With
        ``remat`` each chunk's logits are recomputed in the backward, so
        no more than one chunk's (B, cs, V) f32 logits live at a time."""
        cfg = self.cfg
        B, S = tokens.shape
        x = (self.embed_tokens(tokens) if embeds is None
             else self.embed_vectors(embeds))
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        h, aux = self.hidden_train(x, positions, remat=remat)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        n_chunk = max(S // CE_CHUNK, 1)
        cs = S // n_chunk
        targets = targets.long()
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(n_chunk):
            args = (h[:, c * cs:(c + 1) * cs], head,
                    targets[:, c * cs:(c + 1) * cs], z_loss)
            total = total + (checkpoint(ce_chunk, *args, use_reentrant=False)
                             if remat and torch.is_grad_enabled()
                             else ce_chunk(*args))
        loss = total / (B * n_chunk * cs)
        if cfg.n_experts:
            loss = loss + 0.01 * aux / max(cfg.n_layers, 1)
        return loss

    # ======================== PREFILL ===================================
    def new_cache(self, batch: int, max_len: int, device=None) -> dict:
        """A zeroed cache in the family's layout (module docstring,
        :func:`cache_specs`), on ``device`` (default: the parameters')."""
        dev = device or self.device
        return {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                for n, s in cache_specs(self.cfg, batch, max_len,
                                        self.dtype).items()}

    def prefill(self, tokens: torch.Tensor, max_len: int,
                cache: Optional[dict] = None,
                embeds: Optional[torch.Tensor] = None):
        """tokens (B, S). Returns (last-token logits (B, 1, V), cache); the
        cache's layout is the family's (module docstring), KV caches
        (and rings, when S < W) zero past S. ``cache``, one of
        :meth:`new_cache`'s of this batch and ``max_len``, is
        overwritten in place and returned; by default a
        new one is made. ``embeds`` (B, S, d), a frontend's
        (``models.frontends.input_embeds_for``), replaces the token
        embeddings; positions stay ``arange(S)``, as in JAX."""
        cfg = self.cfg
        B, S = tokens.shape
        if S > max_len and self.kind != "rwkv":
            raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
        if cache is None:
            cache = self.new_cache(B, max_len)
        else:
            self._check_cache(cache, B, max_len)
            for name in ("k", "v", "k_win", "v_win"):
                if name in cache:
                    cache[name][:, :, :, S:].zero_()
        x = (self.embed_tokens(tokens) if embeds is None
             else self.embed_vectors(embeds))
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        if self.kind == "uniform":
            for i, block in enumerate(self.layers):
                x, kv, _ = self._layer(block.attn, block.ffn, x, positions,
                                       update_cache=True)
                cache["k"][i, :, :, :S] = kv["k"]
                cache["v"][i, :, :, :S] = kv["v"]
        elif self.kind == "local_global":
            for block, (glob, j, window) in zip(self.layers, self._lg()):
                x, kv, _ = self._layer(block.attn, block.ffn, x, positions,
                                       window=window, update_cache=True)
                if glob:
                    cache["k"][j, :, :, :S] = kv["k"]
                    cache["v"][j, :, :, :S] = kv["v"]
                else:          # the last min(S, W) keys, p at slot p % W
                    W = cache["k_win"].shape[3]
                    p = torch.arange(max(0, S - W), S, device=x.device)
                    cache["k_win"][j][:, :, p % W] = kv["k"][:, :, p]
                    cache["v_win"][j][:, :, p % W] = kv["v"][:, :, p]
        elif self.kind == "zamba":
            for i, layer in enumerate(self.layers):
                out, cache["ssm_h"][i] = ssm_block(layer, x, cfg,
                                                   kernels=self.kernels)
                x = x + out
                g = self._shared_after(i)
                if g is not None:
                    x, kv, _ = self._layer(self.shared_attn, self.shared_mlp,
                                           x, positions, update_cache=True)
                    cache["k"][g, :, :, :S] = kv["k"]
                    cache["v"][g, :, :, :S] = kv["v"]
        else:
            for i, layer in enumerate(self.layers):
                x, st = rwkv_block(layer, x, cfg, kernels=self.kernels)
                for name, t in st.items():
                    cache[name][i] = t
        logits = self.unembed(self._final_norm(x[:, -1:]))
        return logits, cache

    def _check_cache(self, cache: dict, batch: int, max_len: int) -> None:
        want = {n: (t.shape, t.dtype) for n, t in
                self.new_cache(batch, max_len, device="meta").items()}
        got = {n: (t.shape, t.dtype) for n, t in cache.items()}
        if got != want:
            raise ValueError(f"cache {got} is not the layout {want}")
        if any(t.device != self.device for t in cache.values()):
            raise ValueError(f"cache is not on {self.device}")

    # ======================== DECODE ====================================
    def decode_step(self, token: torch.Tensor, cache: dict,
                    pos: torch.Tensor):
        """token (B,) int; pos (B,) absolute positions. Updates ``cache``
        in place; returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        x = self.embed_tokens(token[:, None])
        positions = pos[:, None]
        lg = self._lg() if self.kind == "local_global" else None
        for i, layer in enumerate(self.layers):
            if self.kind == "uniform":
                x, _, _ = self._layer(layer.attn, layer.ffn, x, positions,
                                      cache={"k": cache["k"][i],
                                             "v": cache["v"][i]},
                                      cache_pos=pos)
            elif self.kind == "local_global":
                glob, j, window = lg[i]
                k, v = ("k", "v") if glob else ("k_win", "v_win")
                x, _, _ = self._layer(layer.attn, layer.ffn, x, positions,
                                      window=window,
                                      cache={"k": cache[k][j],
                                             "v": cache[v][j]},
                                      cache_pos=pos)
            elif self.kind == "zamba":
                out, cache["ssm_h"][i] = ssm_decode(
                    layer, x, cfg, cache["ssm_h"][i], kernels=self.kernels)
                x = x + out
                g = self._shared_after(i)
                if g is not None:
                    x, _, _ = self._layer(self.shared_attn, self.shared_mlp,
                                          x, positions,
                                          cache={"k": cache["k"][g],
                                                 "v": cache["v"][g]},
                                          cache_pos=pos)
            else:
                x, st = rwkv_block(layer, x, cfg,
                                   {n: t[i] for n, t in cache.items()},
                                   kernels=self.kernels)
                for name, t in st.items():
                    cache[name][i] = t
        return self.unembed(self._final_norm(x)), cache
