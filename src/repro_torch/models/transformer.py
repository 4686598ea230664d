"""Decoder-only LM of the port: the ``uniform`` family without MoE.

Counterpart of ``repro.models.transformer.LM`` for dense stacks of
identical layers (deepseek-7b). The layers are an ``nn.ModuleList``
walked by a Python loop where JAX scans a stacked parameter tree. The
KV cache is preallocated at ``(L, B, KV, max_len, hd)`` by ``prefill``
(replacing ``_pad_cache``) and written in place by ``decode_step``.
Other families raise ``NotImplementedError`` until their slice lands.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ops
from .layers import MLP, Attention, _param, attention, mlp, rmsnorm


def family_kind(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.family == "hybrid":
        return "zamba"
    if cfg.local_global_ratio > 0:
        return "local_global"
    return "uniform"


def check_supported(cfg: ModelConfig) -> None:
    kind = family_kind(cfg)
    later = {"local_global": "local_global (gemma3)", "zamba": "zamba",
             "rwkv": "rwkv"}
    if kind in later:
        raise NotImplementedError(
            f"{cfg.name}: family {later[kind]} is not ported yet; it is a "
            "later slice of the port (ROADMAP.md, modules to port)")
    if cfg.n_experts or cfg.first_k_dense or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: MoE, first_k_dense layers and M-RoPE belong to "
            "the 'rest of uniform' slice of the port (ROADMAP.md)")
    if cfg.attn_logit_softcap:
        raise NotImplementedError(f"{cfg.name}: logit softcap not ported")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.attn = Attention(cfg, device=device, dtype=dtype)
        self.mlp = MLP(cfg, device=device, dtype=dtype)


class LM(nn.Module):
    """Parameters: ``embed`` (V, d), ``final_norm`` (d,) and ``lm_head``
    (d, V) in f32, as JAX reads them; per layer ``layers.<i>.attn.*`` and
    ``layers.<i>.mlp.*`` with matmul weights in the compute ``dtype``.

    ``device=None`` means the card (and raises without one). ``kernels``
    is the namespace of the three hot operations: :mod:`..kernels.ops`
    (default) or :mod:`..kernels.plain`.
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16, kernels=ops):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.kernels = kernels
        self.embed = _param((cfg.vocab, cfg.d_model), torch.float32, dev)
        self.final_norm = _param((cfg.d_model,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), torch.float32,
                                  dev)
        self.layers = nn.ModuleList(
            Block(cfg, device=dev, dtype=dtype) for _ in range(cfg.n_layers))

    @classmethod
    def from_params(cls, cfg: ModelConfig, params: dict, *,
                    kernels=ops) -> "LM":
        """Wrap a parameter dict (``repro_torch.params``) without copying
        it; device and compute dtype are the parameters' own."""
        dtype = params["layers.0.attn.wq"].dtype
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

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return h.to(torch.float32) @ head.to(torch.float32)

    # -- one attention + mlp layer ---------------------------------------
    def _layer(self, block: Block, x, positions, *, cache=None,
               cache_pos=None, update_cache=False):
        a, new_kv = attention(block.attn, x, self.cfg, positions=positions,
                              cache=cache, cache_pos=cache_pos,
                              update_cache=update_cache,
                              kernels=self.kernels)
        x = x + a
        x = x + mlp(block.mlp, x, self.cfg, kernels=self.kernels)
        return x, new_kv

    def _final_norm(self, x):
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps,
                       kernels=self.kernels)

    # ======================== TRAIN =====================================
    def logits_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full logits (B, S, V) in f32 — small inputs only (tests)."""
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        for block in self.layers:
            x, _ = self._layer(block, x, positions)
        return self.unembed(self._final_norm(x))

    # ======================== PREFILL ===================================
    def prefill(self, tokens: torch.Tensor, max_len: int):
        """tokens (B, S). Returns (last-token logits (B, 1, V), cache) with
        ``cache = {"k", "v"}`` of (L, B, KV, max_len, hd), zero past S."""
        cfg = self.cfg
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        shape = (cfg.n_layers, B, cfg.n_kv_heads, max_len, cfg.hd)
        cache = {"k": torch.zeros(shape, dtype=self.dtype, device=x.device),
                 "v": torch.zeros(shape, dtype=self.dtype, device=x.device)}
        for i, block in enumerate(self.layers):
            x, kv = self._layer(block, x, positions, update_cache=True)
            cache["k"][i, :, :, :S] = kv["k"]
            cache["v"][i, :, :, :S] = kv["v"]
        logits = self.unembed(self._final_norm(x[:, -1:]))
        return logits, cache

    # ======================== DECODE ====================================
    def decode_step(self, token: torch.Tensor, cache: dict,
                    pos: torch.Tensor):
        """token (B,) int; pos (B,) absolute positions. Writes the new
        k/v into ``cache`` in place; returns (logits (B, 1, V), cache)."""
        x = self.embed_tokens(token[:, None])
        positions = pos[:, None]
        for i, block in enumerate(self.layers):
            x, _ = self._layer(block, x, positions,
                               cache={"k": cache["k"][i],
                                      "v": cache["v"][i]},
                               cache_pos=pos)
        return self.unembed(self._final_norm(x)), cache
