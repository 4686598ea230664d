"""Modality frontend stubs of the port (counterpart of
``repro.models.frontends``).

The vlm and audio archs specify the transformer backbone only; these
stubs stand in for the encoders with deterministic embeddings of the
real interface's shapes, for :meth:`LM.prefill`'s ``embeds``:

* Qwen2-VL: dynamic-resolution ViT patches -> (B, S_img, d) embeddings,
  and 3-D M-RoPE position streams (t, h, w) for the image span.
* MusicGen: EnCodec RVQ tokens, 4 codebooks with the delay pattern ->
  summed codebook embeddings (B, S, d).

The vision stub draws from a ``torch.Generator`` where JAX takes a PRNG
key, so the two packages' patch embeddings are different draws of one
distribution.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..configs.base import ModelConfig


def vision_patch_embeds(cfg: ModelConfig, batch: int, n_patches: int,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
    """Stand-in for the Qwen2-VL ViT: (B, n_patches, d_model) bf16
    embeddings, N(0, 1) * 0.02, drawn from ``generator`` (default: one
    seeded with 0 on ``device``) on its device, returned on ``device``
    (default: the generator's)."""
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    x = torch.randn((batch, n_patches, cfg.d_model), generator=generator,
                    dtype=torch.bfloat16, device=generator.device)
    return (x * 0.02).to(device or generator.device)


def mrope_positions(batch: int, n_text: int, n_patches: int, grid_hw=None,
                    device=None) -> torch.Tensor:
    """3-D position streams (3, B, n_patches + n_text) int32 for an image
    span followed by a text span (Qwen2-VL Sec. 3): the patches share time
    index 0 and walk (h, w) over a grid of ``grid_hw[0]`` rows (default:
    the square root of n_patches); text tokens advance all three streams
    together from 1."""
    h_g = int(n_patches ** 0.5) if grid_hw is None else grid_hw[0]
    w_g = -(-n_patches // h_g)
    i32 = dict(dtype=torch.int32, device=device)
    patch = torch.arange(n_patches, **i32)
    img = torch.stack([torch.zeros(n_patches, **i32), patch // w_g,
                       patch % w_g])
    txt = (torch.arange(n_text, **i32) + 1).expand(3, n_text)
    pos = torch.cat([img, txt], dim=1)                  # (3, S)
    return pos[:, None, :].expand(3, batch, pos.shape[1])


def encodec_token_embeds(embed: torch.Tensor,
                         tokens_4cb: torch.Tensor) -> torch.Tensor:
    """MusicGen frontend: the mean of K codebook embeddings (K = 4) with
    the delay pattern, summed in f32. tokens_4cb: (B, K, S) ints below
    the vocab; codebook k is delayed by k steps, its first k entries set
    to token 0."""
    B, K, S = tokens_4cb.shape
    out = torch.zeros((B, S, embed.shape[1]), dtype=torch.float32,
                      device=embed.device)
    for k in range(K):
        shifted = torch.roll(tokens_4cb[:, k], k, dims=1)
        shifted[:, :k] = 0
        out = out + embed[shifted].to(torch.float32)
    return out / K


def input_embeds_for(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                     tokens: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> Optional[torch.Tensor]:
    """The frontend's embeddings of a (B, S) prompt, or None for a text
    arch. Vision: the first min(S // 4, 256) positions are patch
    embeddings, the rest the unscaled text embeddings, rounded to bf16 as
    the patches are, in every compute dtype. Audio: the four codebooks
    are the prompt rolled by 0-3 steps, modulo the vocab. ``params`` holds
    ``embed`` (V, d)."""
    B, S = tokens.shape
    if cfg.modality == "vision":
        n_img = min(S // 4, 256)
        img = vision_patch_embeds(cfg, B, n_img, generator,
                                  device=tokens.device)
        txt = params["embed"][tokens[:, n_img:]]
        return torch.cat([img, txt.to(img.dtype)], dim=1)
    if cfg.modality == "audio":
        cb = torch.stack([torch.roll(tokens, k, dims=1) for k in range(4)],
                         dim=1) % cfg.vocab
        return encodec_token_embeds(params["embed"], cb)
    return None
