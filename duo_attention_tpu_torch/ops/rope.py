"""Rotary position embeddings (counterpart of duo_attention_tpu/ops/rope.py).

Non-interleaved (rotate-half) layout as in HF Llama. Positions are explicit
integer tensors; ``rope_theta`` and the linear/llama3 scaling come from the
config. The precise mode builds its split-radix tables from float64
frequencies on the host, exactly as the JAX package does. The per-channel
frequencies of either mode are made once per (config, device) and kept there
as device constants: a copy from the host is not allowed inside a captured
CUDA graph, and outside one it would wait for the device every step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ModelConfig, RopeScaling


def _scaled_inv_freq(inv_freq, rs: RopeScaling, where, pi: float):
    """Apply linear or llama3 frequency scaling; ``where`` is np.where or
    torch.where so the float32 and float64 tables share the formula."""
    if rs.rope_type == "linear":
        return inv_freq / rs.factor
    if rs.rope_type == "llama3":
        low_freq_wavelen = rs.original_max_position_embeddings / rs.low_freq_factor
        high_freq_wavelen = rs.original_max_position_embeddings / rs.high_freq_factor
        wavelen = 2 * pi / inv_freq
        smooth = (rs.original_max_position_embeddings / wavelen - rs.low_freq_factor) / (
            rs.high_freq_factor - rs.low_freq_factor
        )
        smoothed = (1 - smooth) * inv_freq / rs.factor + smooth * inv_freq
        return where(
            wavelen > low_freq_wavelen,
            inv_freq / rs.factor,
            where(wavelen < high_freq_wavelen, inv_freq, smoothed),
        )
    return inv_freq


_constants = {}


def _device_constant(name: str, cfg: ModelConfig, device, make):
    """``make()`` computed once per (name, config, device) and kept."""
    key = (name, cfg, str(torch.device(device) if device is not None else "cpu"))
    if key not in _constants:
        _constants[key] = make()
    return _constants[key]


def rope_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Per-channel inverse frequencies [head_dim // 2], float32."""
    dim = cfg.head_dim
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    return _scaled_inv_freq(inv_freq, cfg.rope_scaling, torch.where, math.pi)


def rope_cos_sin(inv_freq: torch.Tensor, positions: torch.Tensor):
    """cos/sin tables for integer positions [...] -> each [..., head_dim]
    float32, half-duplicated (cat([freqs, freqs])) as HF lays them out."""
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


# Split radix of the precise phase path: pos = 4096 q + r, q and r exact in
# float32 for any pos < 2^36.
_SPLIT = 4096


def _inv_freq64(cfg: ModelConfig) -> np.ndarray:
    """Host float64 inverse frequencies (with scaling) for the precise tables."""
    dim = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return _scaled_inv_freq(inv_freq, cfg.rope_scaling, np.where, np.pi)


def rope_cos_sin_precise(cfg: ModelConfig, positions: torch.Tensor):
    """Long-context cos/sin tables with a range-reduced phase.

    A float32 product pos * w carries absolute phase error growing with the
    angle (~0.5 rad at 4M tokens for w = 1). Instead, with w in float64 on
    the host:  pos = 4096 q + r,  w_hi = (4096 w) mod 2pi,
    angle = (q * w_hi) mod 2pi + r * w,  every intermediate < ~4100 rad.
    """
    dev = positions.device

    def tables():
        w64 = _inv_freq64(cfg)
        return (torch.as_tensor(np.mod(_SPLIT * w64, 2 * np.pi), dtype=torch.float32, device=dev),
                torch.as_tensor(w64, dtype=torch.float32, device=dev),
                torch.tensor(2 * np.pi, dtype=torch.float32, device=dev))

    w_hi, w_lo, two_pi = _device_constant("precise", cfg, dev, tables)
    q = torch.div(positions, _SPLIT, rounding_mode="floor").float()[..., None]
    r = torch.remainder(positions, _SPLIT).float()[..., None]
    angles = torch.remainder(q * w_hi, two_pi) + r * w_lo
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin tables for a config: the precise path iff cfg.rope_precise."""
    if cfg.rope_precise:
        return rope_cos_sin_precise(cfg, positions)
    dev = positions.device
    return rope_cos_sin(_device_constant("inv_freq", cfg, dev, lambda: rope_inv_freq(cfg, dev)), positions)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D] or [S, D], broadcast over heads.
    Computed in float32, returned in x's dtype."""
    if cos.dim() == x.dim() - 1:
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
