"""Token sampling: temperature / top-k / top-p (nucleus), on JAX's random stream.

Counterpart of duo_attention_tpu/ops/sampling.py. The filter is the same:
one descending stable sort serves all three knobs, a token is kept iff the
probability mass strictly before it is < top_p (the head token always
survives), ``top_k == 0`` means off, and rows with temperature 0 return the
argmax (``order[:, 0]``) exactly.

The draws come from JAX's own counter-based generator (threefry2x32 with
``jax_threefry_partitionable``), written here in plain PyTorch on int64
tensors holding 32-bit words. Keys are device tensors ([2] words, or [B, 2]
for per-row keys), so:

* the bits and split keys equal JAX's bit for bit, and a sampled stream can
  be held to the JAX package's token for token (the Gumbel noise is JAX's
  up to the last bits of ``log``);
* a draw reads and writes only tensors, with no ``torch.Generator`` state,
  so a decode step that samples captures into a CUDA graph and draws anew on
  every replay;
* a request's stream depends only on its own key
  (``sample_tokens_rowkeys``), whichever requests share the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side).

    temperature == 0.0 -> greedy argmax (top_p/top_k ignored).
    """

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    seed: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


# ---------------------------------------------------------------------------
# threefry2x32 (jax/_src/prng.py), on int64 tensors holding uint32 words
# ---------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the count pairs (x1, x2) under the key
    (k1, k2): 20 rounds, a key injection after every 4. All int64 tensors of
    32-bit words that broadcast together (keys e.g. [B, 1] against counts
    [V]). Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key words (seed >> 32, seed & 0xFFFFFFFF)
    as an int64 [2] tensor on ``device`` (the card unless the caller asks for
    the CPU; raises without one). seed: 0 <= seed < 2**63."""
    seed = int(seed)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64, device=resolve_device(device))


def _iota_2x32(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) words of the uint64 counts 0 .. n-1."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: key [..., 2] -> [..., num, 2], each
    leading key split on its own (as ``vmap`` of the split does)."""
    hi, lo = _iota_2x32(num, key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)  # [..., num] each
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words, as int64): the hash of
    the flat index of every element, both output words xor-ed. key [..., 2]
    draws a leading batch of independent arrays: [..., *shape]."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _iota_2x32(n, key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return (b1 ^ b2).reshape(*key.shape[:-1], *shape)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform in [0, 1) from 32 random bits: the top 23 bits
    as the mantissa of a float in [1, 2), minus 1."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32, mode="low")``: -log(-log(u))
    of a uniform u in [tiny, 1). key [..., 2] -> [..., *shape]."""
    u = uniform_from_bits(random_bits(key, shape))
    u = torch.clamp_min(u + _F32_TINY, _F32_TINY)  # JAX: max(tiny, u * (1 - tiny) + tiny)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# The filter and the draws
# ---------------------------------------------------------------------------


def _filtered(logits: torch.Tensor, temperature, top_p, top_k):
    """Shared filter: one descending stable sort serves all three knobs.

    Returns (order [B, V], masked scaled logits [B, V])."""
    V = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)  # descending, ties by index
    sorted_logits = torch.gather(logits, -1, order)
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    scaled = sorted_logits / temp
    probs = torch.softmax(scaled, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs  # mass strictly before
    rank = torch.arange(V, dtype=torch.int32, device=logits.device)[None, :]
    keep = cum_before < top_p[:, None]
    keep &= (top_k[:, None] == 0) | (rank < top_k[:, None])
    keep[:, 0] = True  # head token always survives
    return order, torch.where(keep, scaled, torch.full_like(scaled, float("-inf")))


def _pick(order, masked, noise, temperature) -> torch.Tensor:
    """argmax(masked + noise) mapped back through ``order``; greedy rows
    (temperature 0) take the head of the order."""
    sampled_rank = torch.argmax(masked + noise, dim=-1)
    sampled = torch.gather(order, -1, sampled_rank[:, None])[:, 0]
    return torch.where(temperature == 0.0, order[:, 0], sampled)


def sample_tokens(logits: torch.Tensor, key: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Sample one token per row with one key for the batch (``categorical``
    over the [B, V] filtered logits). logits [B, V] float32; key [2];
    temperature/top_p [B] float32; top_k [B] int (0 = off). Returns [B]
    int64. Rows with temperature == 0 return the argmax exactly."""
    order, masked = _filtered(logits, temperature, top_p, top_k)
    return _pick(order, masked, gumbel(key, masked.shape), temperature)


def sample_tokens_rowkeys(logits: torch.Tensor, keys: torch.Tensor, temperature: torch.Tensor,
                          top_p: torch.Tensor, top_k: torch.Tensor):
    """Per-row-keyed sampling for continuous batching: each sequence owns its
    key, so its tokens do not depend on which other requests share the batch.
    keys [B, 2]. Each key splits into (next key, subkey); the subkey draws the
    row's Gumbel noise over [V]. Returns (tokens [B] int64, next keys [B, 2])."""
    both = split(keys, 2)  # [B, 2, 2]
    keys_next, subkeys = both[:, 0], both[:, 1]
    order, masked = _filtered(logits, temperature, top_p, top_k)
    noise = gumbel(subkeys, (logits.shape[-1],))  # [B, V]
    return _pick(order, masked, noise, temperature), keys_next


def params_to_vectors(params_list, batch_size: int):
    """Host helper: list of Optional[SamplingParams] (len <= batch_size,
    None = greedy) -> ([B] temperature, [B] top_p, [B] top_k) numpy."""
    temp = np.zeros(batch_size, np.float32)
    top_p = np.ones(batch_size, np.float32)
    top_k = np.zeros(batch_size, np.int32)
    for i, p in enumerate(params_list):
        if p is not None:
            temp[i] = p.temperature
            top_p[i] = p.top_p
            top_k[i] = p.top_k
    return temp, top_p, top_k
