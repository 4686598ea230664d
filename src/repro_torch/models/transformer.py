"""Decoder-only LM of the port: the ``uniform``, ``zamba`` and ``rwkv``
families.

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
* zamba: ``layers.<i>.*`` Mamba2 layers, the JAX ``blocks`` (G, every)
  stack then the ``tail``, and one weight-shared ``shared_attn`` /
  ``shared_mlp`` block applied after each group of ``every`` layers
  (zamba2-1.2b);
* rwkv: ``layers.<i>.*`` RWKV6 layers (rwkv6-1.6b).

``prefill`` returns the port's own cache, preallocated (``new_cache``, or
the caller's, as the serving engine's slots pass theirs) and written in
place by ``decode_step`` (replacing ``_pad_cache``): uniform
``{"k", "v"}`` of (L, B, KV, max_len, hd) over head and body layers
together (JAX keeps ``cache["head"]`` and ``cache["body"]``); zamba
``{"ssm_h"}`` of (L, B, nh, hd, ds) f32 beside ``{"k", "v"}`` of (G, B,
KV, max_len, hd) for the shared block's G applications; rwkv ``{"S",
"x_tm", "x_cm"}`` as JAX's (L, B, ...) f32. ``local_global`` (gemma3) and the
logit softcap raise ``NotImplementedError`` until their slice lands.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ops
from .layers import (MATMUL, MLP, Attention, MoE, _param, attention, mlp,
                     moe, rmsnorm)
from .rwkv import RWKV, rwkv_block, rwkv_dims
from .ssm import SSM, ssm_block, ssm_decode, ssm_dims


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


def check_supported(cfg: ModelConfig) -> None:
    if family_kind(cfg) == "local_global":
        raise NotImplementedError(
            f"{cfg.name}: family local_global (gemma3) is not ported yet; it "
            "is a later slice of the port (ROADMAP.md, modules to port)")
    if cfg.attn_logit_softcap:
        raise NotImplementedError(f"{cfg.name}: logit softcap not ported")


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
    docstring) with matmul weights in the compute ``dtype`` and every
    other leaf in f32.

    ``device=None`` means the card (and raises without one). ``kernels``
    is the namespace of the hot operations: :mod:`..kernels.ops`
    (default) or :mod:`..kernels.plain`.
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16, kernels=ops):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.kind = family_kind(cfg)
        self.dtype = dtype
        self.kernels = kernels
        self.embed = _param((cfg.vocab, cfg.d_model), torch.float32, dev)
        self.final_norm = _param((cfg.d_model,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), torch.float32,
                                  dev)
        if self.kind == "uniform":
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
                    kernels=ops) -> "LM":
        """Wrap a parameter dict (``repro_torch.params``) without copying
        it; device and compute dtype are the parameters' own (the dtype
        of the matmul weights)."""
        dtype = next(t.dtype for n, t in params.items()
                     if n.rsplit(".", 1)[-1] in MATMUL)
        device = params["embed"].device
        lm = cls(cfg, device="meta", dtype=dtype, kernels=kernels)
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
        then cast to the compute dtype."""
        x = self.embed[tokens] * math.sqrt(self.cfg.d_model)
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
               cache=None, cache_pos=None, update_cache=False):
        a, new_kv = attention(attn, x, self.cfg, positions=positions,
                              cache=cache, cache_pos=cache_pos,
                              update_cache=update_cache,
                              kernels=self.kernels)
        x = x + a
        if isinstance(ffn, MoE):
            x = x + moe(ffn, x, self.cfg, kernels=self.kernels, aux=False)[0]
        else:
            x = x + mlp(ffn, x, self.cfg, kernels=self.kernels)
        return x, new_kv

    def _final_norm(self, x):
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps,
                       kernels=self.kernels)

    def _shared_after(self, i: int) -> Optional[int]:
        """zamba: the shared block's application index after SSM layer
        ``i``, or None."""
        G, _ = zamba_groups(self.cfg)
        every = self.cfg.shared_attn_every
        if self.kind == "zamba" and i < G * every and (i + 1) % every == 0:
            return i // every
        return None

    # ======================== TRAIN =====================================
    def logits_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full logits (B, S, V) in f32 — small inputs only (tests)."""
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        for i, layer in enumerate(self.layers):
            if self.kind == "uniform":
                x, _ = self._layer(layer.attn, layer.ffn, x, positions)
            elif self.kind == "zamba":
                x = x + ssm_block(layer, x, self.cfg,
                                  kernels=self.kernels)[0]
                if self._shared_after(i) is not None:
                    x, _ = self._layer(self.shared_attn, self.shared_mlp, x,
                                       positions)
            else:
                x, _ = rwkv_block(layer, x, self.cfg, kernels=self.kernels)
        return self.unembed(self._final_norm(x))

    # ======================== PREFILL ===================================
    def new_cache(self, batch: int, max_len: int, device=None) -> dict:
        """A zeroed cache in the family's layout (module docstring), on
        ``device`` (default: the parameters')."""
        cfg, dev = self.cfg, device or self.device
        f32 = dict(dtype=torch.float32, device=dev)
        if self.kind == "rwkv":
            nh, hd = rwkv_dims(cfg)
            return {"S": torch.zeros(cfg.n_layers, batch, nh, hd, hd, **f32),
                    "x_tm": torch.zeros(cfg.n_layers, batch, cfg.d_model,
                                        **f32),
                    "x_cm": torch.zeros(cfg.n_layers, batch, cfg.d_model,
                                        **f32)}
        n = cfg.n_layers if self.kind == "uniform" else zamba_groups(cfg)[0]
        shape = (n, batch, cfg.n_kv_heads, max_len, cfg.hd)
        cache = {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                 "v": torch.zeros(shape, dtype=self.dtype, device=dev)}
        if self.kind == "zamba":
            _, nh, hd, ds = ssm_dims(cfg)
            cache["ssm_h"] = torch.zeros(cfg.n_layers, batch, nh, hd, ds,
                                         **f32)
        return cache

    def prefill(self, tokens: torch.Tensor, max_len: int,
                cache: Optional[dict] = None,
                embeds: Optional[torch.Tensor] = None):
        """tokens (B, S). Returns (last-token logits (B, 1, V), cache); the
        cache's layout is the family's (module docstring), KV caches zero
        past S. ``cache``, one of :meth:`new_cache`'s of this batch and
        ``max_len``, is overwritten in place and returned; by default a
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
            for name in ("k", "v"):
                if name in cache:
                    cache[name][:, :, :, S:].zero_()
        x = (self.embed_tokens(tokens) if embeds is None
             else self.embed_vectors(embeds))
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        if self.kind == "uniform":
            for i, block in enumerate(self.layers):
                x, kv = self._layer(block.attn, block.ffn, x, positions,
                                    update_cache=True)
                cache["k"][i, :, :, :S] = kv["k"]
                cache["v"][i, :, :, :S] = kv["v"]
        elif self.kind == "zamba":
            for i, layer in enumerate(self.layers):
                out, cache["ssm_h"][i] = ssm_block(layer, x, cfg,
                                                   kernels=self.kernels)
                x = x + out
                g = self._shared_after(i)
                if g is not None:
                    x, kv = self._layer(self.shared_attn, self.shared_mlp, x,
                                        positions, update_cache=True)
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
        for i, layer in enumerate(self.layers):
            if self.kind == "uniform":
                x, _ = self._layer(layer.attn, layer.ffn, x, positions,
                                   cache={"k": cache["k"][i],
                                          "v": cache["v"][i]},
                                   cache_pos=pos)
            elif self.kind == "zamba":
                out, cache["ssm_h"][i] = ssm_decode(
                    layer, x, cfg, cache["ssm_h"][i], kernels=self.kernels)
                x = x + out
                g = self._shared_after(i)
                if g is not None:
                    x, _ = self._layer(self.shared_attn, self.shared_mlp, x,
                                       positions,
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
