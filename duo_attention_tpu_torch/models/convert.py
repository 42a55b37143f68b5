"""HF checkpoint conversion with load-time KV-head reordering.

Counterpart of duo_attention_tpu/models/convert.py. The reference deploys
DuoAttention by permuting the q/k/v/o projections of a loaded HF model so
the retrieval heads take a leading contiguous slice
(duo_attn/patch/utils.py:6-45); here the permutation is applied once while
an HF checkpoint (safetensors or torch .bin shards) becomes the port's
params dict, and each layer's ``num_full_kv_heads`` goes into the
``DuoConfig``.

Layout: HF stores projections [out_features, in_features], which is the
port's layout too (``F.linear``), so nothing is transposed; the head
permutation is a row gather on q/k/v and a column gather on o
(``index_select``), fused into the one pass that reads the mmap'd
checkpoint.

bf16 tensors are read as uint16 words (tagged by their numpy dtype's
metadata, ``BF16``) and viewed as ``torch.bfloat16``; no ``ml_dtypes``.
For W8A8 serving, quantize after the reorder (``ops.quant.quantize_params_w8a8``),
or reorder already-quantized params with ``reorder_params``.
"""

from __future__ import annotations

import glob
import json
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DuoConfig, ModelConfig, load_hf_config
from ..patterns import expand_kv_perm, head_permutation
from ..utils import resolve_device

# bf16 words as numpy holds them: uint16, tagged so the conversion views them
# as torch.bfloat16 (the tag survives slicing, reshapes and the gathers)
BF16 = np.dtype(np.uint16, metadata={"torch_dtype": "bfloat16"})

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def _st_dtype(name: str) -> np.dtype:
    return BF16 if name == "BF16" else np.dtype(_ST_DTYPES[name])


def is_bf16(arr: np.ndarray) -> bool:
    return (arr.dtype.metadata or {}).get("torch_dtype") == "bfloat16"


def mmap_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Zero-copy safetensors reader: tensors are views into an mmap.

    Format: u64le header length, JSON header {name: {dtype, shape,
    data_offsets}}, then the data. The views stay valid for the life of the
    returned arrays (their base keeps the mmap). BF16 tensors come back as
    uint16 words of dtype ``BF16``."""
    blob = np.memmap(path, dtype=np.uint8, mode="r")
    n = int(np.frombuffer(blob[:8].tobytes(), dtype="<u8")[0])
    header = json.loads(blob[8 : 8 + n].tobytes())
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        b, e = meta["data_offsets"]
        out[name] = blob[base + b : base + e].view(_st_dtype(meta["dtype"])).reshape(meta["shape"])
    return out


def _load_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """Every tensor of a sharded HF checkpoint as a numpy array (mmap-backed
    views for safetensors shards; torch .bin shards as float32)."""
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    state = {}
    if st_files:
        for path in st_files:
            state.update(mmap_safetensors(path))
        return state
    bin_files = sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no checkpoint shards found in {model_dir}")
    for path in bin_files:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for name, t in sd.items():
            state[name] = t.to(torch.float32).numpy()
    return state


def _host_tensor(x: np.ndarray) -> torch.Tensor:
    """A tensor over the host array's memory, no copy (bf16 words as
    ``torch.bfloat16``). Nothing writes through it: a checkpoint's mmap is
    read-only."""
    with warnings.catch_warnings():  # torch warns that the array is not writable
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(x.view(np.int16) if is_bf16(x) else x)
    return t.view(torch.bfloat16) if is_bf16(x) else t


def _gathered(x: np.ndarray, perm=None, col_perm=None) -> torch.Tensor:
    """The array as a host tensor with the head permutation fused into its
    read: ``index_select`` on the rows (q/k/v and their biases) and on the
    columns (o); with neither, a view of x."""
    t = _host_tensor(x)
    for dim, p in ((0, perm), (1, col_perm)):
        if p is not None:
            t = t.index_select(dim, torch.as_tensor(np.asarray(p), dtype=torch.long))
    return t


def params_from_state_dict(state: Dict[str, np.ndarray], cfg: ModelConfig, dtype=torch.bfloat16,
                           layer_perms=None, device="cuda") -> Dict:
    """Map HF llama/mistral tensor names onto the port's params dict.

    HF -> port: model.embed_tokens.weight -> embed;
    model.layers.{i}.self_attn.{q,k,v,o}_proj.weight -> wq/wk/wv/wo;
    model.layers.{i}.mlp.{gate,up,down}_proj.weight -> w_gate/w_up/w_down;
    (Mixtral) model.layers.{i}.block_sparse_moe.gate.weight -> moe_gate,
    transposed to JAX's [hidden, X] float32, and
    block_sparse_moe.experts.{e}.{w1,w3,w2}.weight -> experts_w_gate /
    experts_w_up / experts_w_down, stacked on a leading expert axis;
    model.layers.{i}.{input,post_attention}_layernorm.weight -> norms;
    model.norm.weight -> final_norm; lm_head.weight -> lm_head (absent when
    tie_word_embeddings). All [out, in] as HF stores them.

    layer_perms: optional per-layer KV-head permutations
    (``patterns.head_permutation``), fused into the one read of each
    projection (rows of q/k/v and their biases, columns of o) instead of a
    later ``reorder_params``. The MoE leaves are never permuted: the head
    reorder touches attention only.
    """
    device = resolve_device(device)

    def get(name):
        if name not in state:
            raise KeyError(f"missing tensor {name!r} in checkpoint")
        return state[name]

    def tensor(x, perm=None, col_perm=None):
        # a copy even where nothing moves: the params never alias the read-only mmap
        return _gathered(x, perm, col_perm).to(device=device, dtype=dtype, copy=True)

    def stacked(names):
        # one device tensor the experts are copied into, each from its mmap'd view
        first = _gathered(get(names[0]))
        out = torch.empty((len(names), *first.shape), dtype=dtype, device=device)
        for e, name in enumerate(names):
            out[e].copy_(_gathered(get(name)))
        return out

    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        if layer_perms is not None:
            kv_chan = expand_kv_perm(layer_perms[i], cfg.head_dim)
            q_chan = expand_kv_perm(layer_perms[i], cfg.num_kv_groups * cfg.head_dim)
        else:
            kv_chan = q_chan = None
        layer = {
            "input_norm": tensor(get(pre + "input_layernorm.weight")),
            "post_norm": tensor(get(pre + "post_attention_layernorm.weight")),
            "wq": tensor(get(pre + "self_attn.q_proj.weight"), perm=q_chan),
            "wk": tensor(get(pre + "self_attn.k_proj.weight"), perm=kv_chan),
            "wv": tensor(get(pre + "self_attn.v_proj.weight"), perm=kv_chan),
            "wo": tensor(get(pre + "self_attn.o_proj.weight"), col_perm=q_chan),
        }
        if cfg.num_local_experts > 0:
            moe = pre + "block_sparse_moe."
            # [X, hidden] -> JAX's [hidden, X], float32 (the copy is the transpose's)
            gate = _gathered(get(moe + "gate.weight")).to(device=device, dtype=torch.float32)
            layer["moe_gate"] = gate.t().contiguous()
            for ours, hf in (("experts_w_gate", "w1"), ("experts_w_up", "w3"), ("experts_w_down", "w2")):
                layer[ours] = stacked([f"{moe}experts.{e}.{hf}.weight" for e in range(cfg.num_local_experts)])
        else:
            layer["w_gate"] = tensor(get(pre + "mlp.gate_proj.weight"))
            layer["w_up"] = tensor(get(pre + "mlp.up_proj.weight"))
            layer["w_down"] = tensor(get(pre + "mlp.down_proj.weight"))
        if cfg.attention_bias:
            for ours, hf, chan in (("bq", "q_proj", q_chan), ("bk", "k_proj", kv_chan), ("bv", "v_proj", kv_chan)):
                layer[ours] = tensor(get(pre + f"self_attn.{hf}.bias"), perm=chan)
        layers.append(layer)

    params = {"embed": tensor(get("model.embed_tokens.weight")), "layers": layers,
              "final_norm": tensor(get("model.norm.weight"))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = tensor(get("lm_head.weight"))
    return params


# ---------------------------------------------------------------------------
# Load-time head reordering (retrieval heads first)
# ---------------------------------------------------------------------------


def reorder_layer(layer: Dict, perm: np.ndarray, cfg: ModelConfig) -> Dict:
    """Permute one layer's projections by a KV-head permutation.

    Out-channel permutation on q (group-expanded) and k/v, in-channel on o:
    the reference's reorder_linear_weights (duo_attn/patch/utils.py:6-34) in
    the port's [out, in] layout. An already-quantized layer (W8A8) permutes
    the int8 rows of q/k/v with their per-out-channel scales, and the int8
    columns of o (whose scale is per out-channel, so untouched). Every other
    leaf (norms, the MLP or a MoE layer's router and experts) is carried
    through as it is."""
    kv_chan = expand_kv_perm(perm, cfg.head_dim)
    q_chan = expand_kv_perm(perm, cfg.num_kv_groups * cfg.head_dim)
    out = dict(layer)

    def rows(t, chan):
        return t.index_select(0, torch.as_tensor(chan, device=t.device))

    def cols(t, chan):
        return t.index_select(1, torch.as_tensor(chan, device=t.device))

    suffix = "_q8" if "wq_q8" in layer else ""
    for name, chan in (("wq", q_chan), ("wk", kv_chan), ("wv", kv_chan)):
        out[name + suffix] = rows(layer[name + suffix], chan)
        if suffix:
            out[name + "_scale"] = rows(layer[name + "_scale"], chan)
    out["wo" + suffix] = cols(layer["wo" + suffix], q_chan)
    if "bq" in layer:
        out["bq"], out["bk"], out["bv"] = rows(layer["bq"], q_chan), rows(layer["bk"], kv_chan), rows(layer["bv"], kv_chan)
    return out


def reorder_params(params: Dict, cfg: ModelConfig, binary_heads: np.ndarray) -> Tuple[Dict, Tuple[int, ...]]:
    """Apply per-layer retrieval-heads-first permutations to a params dict.

    binary_heads: [num_layers, num_kv_heads] gates already binarized by
    ``patterns.sparsify_attention_heads``. Returns (reordered params,
    per-layer num_full_kv_heads tuple) — the latter goes into DuoConfig."""
    binary_heads = np.atleast_2d(np.asarray(binary_heads))
    if binary_heads.shape != (cfg.num_layers, cfg.num_kv_heads):
        raise ValueError(f"gates {binary_heads.shape}, model {(cfg.num_layers, cfg.num_kv_heads)}")
    layers, num_full = [], []
    for li, layer in enumerate(params["layers"]):
        perm, nf = head_permutation(binary_heads[li])
        layers.append(reorder_layer(layer, perm, cfg))
        num_full.append(nf)
    return dict(params, layers=layers), tuple(num_full)


# ---------------------------------------------------------------------------
# One-call loader
# ---------------------------------------------------------------------------


def load_hf_model(model_dir: str, binary_heads: np.ndarray, sink_size: int, recent_size: int,
                  max_cache_size: int = 32768, prefill_chunk_size: int = 8192, dtype=torch.bfloat16,
                  cfg: Optional[ModelConfig] = None, device="cuda") -> Tuple[Dict, ModelConfig, DuoConfig]:
    """HF checkpoint dir + binarized gate matrix -> (params, cfg, duo), the
    weights on ``device`` (the card unless the caller asks for the CPU).

    The counterpart of the reference's ``from_pretrained`` +
    ``enable_duo_attention_eval``: the enable step's weight reorder happens
    here, fused into the one read of the checkpoint."""
    if cfg is None:
        cfg = load_hf_config(os.path.join(model_dir, "config.json"))
    binary = np.atleast_2d(np.asarray(binary_heads))
    if binary.shape != (cfg.num_layers, cfg.num_kv_heads):
        raise ValueError(f"gates {binary.shape}, model {(cfg.num_layers, cfg.num_kv_heads)}")
    perms, num_full = zip(*(head_permutation(binary[li]) for li in range(cfg.num_layers)))
    params = params_from_state_dict(_load_state_dict(model_dir), cfg, dtype, layer_perms=perms, device=device)
    duo = DuoConfig(sink_size=sink_size, recent_size=recent_size, num_full_kv_heads=tuple(num_full),
                    max_cache_size=max_cache_size, prefill_chunk_size=prefill_chunk_size)
    return params, cfg, duo


# ---------------------------------------------------------------------------
# Flat .npz interchange (the port's own layout)
# ---------------------------------------------------------------------------

_BF16_KEY = "__bfloat16__"  # names of the arrays saved as bf16 words


def save_params_npz(params: Dict, path: str) -> None:
    """Flat .npz export of a params dict: ``layers.{i}.{name}`` and the
    top-level tensors; bf16 tensors as their uint16 words, listed under
    ``__bfloat16__``."""
    flat, bf16 = {}, []
    items = [(f"layers.{i}.{k}", v) for i, layer in enumerate(params["layers"]) for k, v in layer.items()]
    items += [(k, v) for k, v in params.items() if k != "layers"]
    for name, t in items:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            bf16.append(name)
            t = t.view(torch.int16)
        flat[name] = t.numpy()
    np.savez(path, **flat, **{_BF16_KEY: np.asarray(bf16, dtype=str)})


def load_params_npz(path: str, cfg: ModelConfig, dtype=None, device="cuda") -> Dict:
    """A ``save_params_npz`` file back into a params dict on ``device``; each
    tensor in its saved dtype, or in ``dtype`` when given."""
    device = resolve_device(device)
    data = np.load(path)
    bf16 = set(data[_BF16_KEY].tolist()) if _BF16_KEY in data.files else set()

    def tensor(name):
        t = torch.from_numpy(np.array(data[name]))
        if name in bf16:
            t = t.view(torch.bfloat16)
        return t.to(device=device, dtype=dtype or t.dtype)

    names = [k for k in data.files if k != _BF16_KEY]
    layers = []
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        layers.append({k[len(pre):]: tensor(k) for k in names if k.startswith(pre)})
    params = {k: tensor(k) for k in names if not k.startswith("layers.")}
    params["layers"] = layers
    return params
