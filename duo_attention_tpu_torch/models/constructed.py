"""Hand-constructed retrieval model: an exact induction circuit in Llama form.

The port's own copy of duo_attention_tpu/models/constructed.py: the same
numpy construction (signatures, circuit layers, specs), whose params leave
through ``models/from_jax.py``'s rules into the port's ``[out, in]`` layout,
so each projection is transposed exactly once and the float32 params equal
the JAX package's after ``params_from_numpy`` bit for bit
(tests/test_torch_constructed.py). ``build_params_w8a8`` builds the circuit
directly in the W8A8 serving form on the card; its docstring says how.

The JAX package's notes on the circuit follow.

The accuracy loop (evals/accuracy_loop.py) needs a model that SOLVES the
passkey task with full attention. VERDICT r1 allows "pretrain (or
directly construct)" — and controlled experiments in this environment
showed gradient descent does not discover content-based induction within
budget (fixed-offset copying converges in ~400 steps, but any
variable-offset variant stays at the entropy floor: the model keeps
finding positional shortcuts). So this module WRITES the circuit into
the weights of this repo's own Llama architecture (RMSNorm + RoPE + GQA
+ SwiGLU, models/llama.py) — no architectural changes, every framework
path (engine, kernels, gate trainer) runs it like any checkpoint.

The circuit (2 layers, 4 heads each, head_dim 64):

  layer 0, head 0   previous-token head (offset 1): bias-only q/k whose
                    RoPE phases form a kernel peaked at j = i-1; copies
                    the match-signature of token_{i-1} into subspace B1.
  layer 0, head 1   offset-2 head -> subspace B2.
  layer 1, head 0   bigram induction head: matches ("{name}", "is")
                    against (B2_j, B1_j) in rotation-slow dims, reads the
                    output-signature of token_j into subspace C — fires
                    exactly at the first passkey word.
  layer 1, head 1   unigram continuation head: matches token_i == code
                    word token_{j-1}; chains w2, w3 and the final ".".
  all other heads   zero (streaming-compatible by construction).

Head-type ground truth: layer-1 heads {0,1} are retrieval heads (their
keys live arbitrarily deep in the context); layer-0 heads are strictly
local (offsets 1-2 << recent window) — the exact structure DuoAttention
gates are meant to discover, so the gate trainer can be validated against
a KNOWN answer.

Signature spaces (hidden 256 = 4 x 64-dim subspaces A|B1|B2|C):
  match signatures: orthonormal basis over {20 names, 26 code words,
  "is"}; placed in the rotation-slow RoPE pairs so matching is
  position-invariant over the spec's range. output signatures:
  orthonormal basis over {26 code words, "."} in C, read by the lm_head.

Three specs (scripts/design_long_circuit.py is the design/validation tool):

  BASE_SPEC  theta 1e8, range 32k: match pairs 16..31 (pair 16 drifts
             1e-4 rad/token — score retention ~0.73 at a 32k separation,
             the measured edge of this variant), positional kernel on 8
             fast pairs with margin 0.13 over D in [0, 4096].
  LONG_SPEC  theta 1e14, range 4.2M (past the reference's 3.3M demo,
             demo/run_duo_w8a8kv4.py:83-206): match pairs 16..31 — the
             worst pair drifts 0.42 rad over 4.2M (average-energy
             retention 0.99, worst single-pair-concentrated code 0.91,
             vs the 30-nat sink at lambda_match 40); positional kernel
             on the 15 pairs that still vary over 4.2M, LP-optimized min
             margin 0.1656 over the WHOLE range (softmax noise mass
             <= 1e-5 at lambda_pos 100 under INT4-KV score noise).
             Requires rope_precise (f32 phase error alone is ~0.5 rad
             at 4M).
  LONG_8B_SPEC  the LONG_SPEC circuit grafted into the FULL Llama-3-8B
             geometry (32 layers / 4096 hidden / 32 q + 8 kv heads /
             head_dim 128 / vocab 128256 — config.LLAMA3_8B_1048K's
             shapes): the circuit occupies layers 0-1, the other 30
             layers are exact residual pass-throughs (zero attention +
             MLP output), so the whole 8B-scale serving stack — W8A8
             GEMMs, INT4 KV, chunked prefill, decode kernels — runs at
             flagship cost while retrieval accuracy is attested by the
             SAME model (reference analog: the real-checkpoint 3.3M demo,
             demo/run_duo_w8a8kv4.py:83-206). Grafting preserves the
             validated E=256 score calibration exactly: all RMSNorm
             weight vectors are scaled by sqrt(256/E) so post-norm
             activations match the 2-layer circuit's, and the positional
             kernel reuses LONG_SPEC's LP-optimal amplitudes on the even
             pairs of the 128-dim head (identical frequencies:
             theta^(-2p/128) at p=2k equals theta^(-k/32) at D=64).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from ..config import ModelConfig
from ..ops.quant import QUANTIZED_PROJECTIONS, quantize_weight_int8
from ..train.data import _CODE_WORDS, _NAMES
from ..utils import resolve_device
from .from_jax import leaf_from_numpy, params_from_numpy

E = 256   # hidden size the circuit math is calibrated at (see norm trick)
D = 64    # head_dim of the minimal carrier
NH = 4    # heads per layer of the minimal carrier (MHA)

# subspace slices of the residual stream
A = slice(0, 64)    # current-token match signature (embedding)
B1 = slice(64, 128)   # token_{i-1} signature (layer-0 head 0)
B2 = slice(128, 192)  # token_{i-2} signature (layer-0 head 1)
C = slice(192, 256)   # copied-output signature (layer-1 heads)

# Attention outputs write at 1/16 so every residual subspace carries
# ~unit magnitude (RMSNorm emits 16x-unit components for a 1-subspace
# residual at E=256). Unbalanced subspaces break GATE TRAINING, not
# inference: with B1/B2 at 16x, the retrieval-bearing C subspace is 0.05%
# of the distill MSE and the L1 regularizer drives every gate to zero
# (measured); balanced, C is ~10% of the loss and the gates separate.
#
# Hosts wider than E=256 keep these calibrations VERBATIM via the norm
# trick: every RMSNorm weight vector is uniformly sqrt(256/E_host), which
# makes post-norm activations identical to the E=256 circuit's (RMS over
# E_host dims of the same 256-dim content is sqrt(256/E_host) smaller).
W_OUT_SCALE = 1.0 / 16.0
EXPECTED_KEY_NORM = 16.0 / np.sqrt(3.0)  # per-unit component post-norm


def _legacy_amps() -> Tuple[float, ...]:
    amps = np.linspace(2.0, 0.5, 8)  # fast-weighted: best measured
    return tuple(amps / amps.sum())  # gap 0.13 over Delta in 0..4096


@dataclasses.dataclass(frozen=True)
class CircuitSpec:
    """Position-range design of the circuit (see module docstring)."""

    rope_theta: float = 1e8
    max_position_embeddings: int = 32768
    rope_precise: bool = False
    # rotation pairs carrying the match codes (slowest pairs)
    match_pairs: Tuple[int, ...] = tuple(range(16, 32))
    # positional-kernel amplitudes (sum to 1), placed on ``pos_pairs``
    # (None -> the first len(pos_amps) pairs — the legacy layout)
    pos_amps: Tuple[float, ...] = dataclasses.field(
        default_factory=_legacy_amps
    )
    pos_pairs: Optional[Tuple[int, ...]] = None
    lambda_match: float = 40.0  # pre-softmax score scale for exact match
    lambda_pos: float = 100.0   # positional kernel score scale
    lambda_out: float = 25.0    # lm_head logit scale
    # BOS-sink score for the induction heads: when nothing matches, all
    # attention parks on BOS (whose value is zero) instead of spreading
    # uniformly — uniform spread averages many "."-position values into C
    # and drowns the real signal (measured: logit 22.6 for "." vs 17.7
    # for the retrieved word). Far above noise (0), far below a match.
    lambda_sink: float = 30.0
    # ---- host geometry the circuit is written into (defaults = the
    # minimal 2-layer carrier; LONG_8B_SPEC = the full 8B geometry) ----
    hidden_size: int = E
    head_dim: int = D
    num_layers: int = 2
    num_heads: int = NH
    num_kv_heads: int = NH
    intermediate_size: int = 64
    vocab_size: int = 512
    # the two layers hosting the circuit: (local-heads layer, induction
    # layer); every other host layer is an exact residual pass-through
    circuit_layers: Tuple[int, int] = (0, 1)
    # Opt-in digit vocabulary "1".."{num_digits}": digits become
    # retrievable/emittable like code words, making the LongBench
    # retrieval_score family ("Paragraph N" answers) expressible in the
    # grammar. Costs signature rows (names 20 + codes 26 + is + digits
    # + BOS <= 64) and continuation-code rows (26 + digits + 1 <=
    # code_dim) — so it needs the 64-dim codes of a head_dim-128 spec;
    # 0 keeps the original circuits bit-identical.
    num_digits: int = 0

    @property
    def code_dim(self) -> int:
        return 2 * len(self.match_pairs)

    @property
    def positional_pairs(self) -> Tuple[int, ...]:
        return (self.pos_pairs if self.pos_pairs is not None
                else tuple(range(len(self.pos_amps))))

    @property
    def norm_scale(self) -> float:
        """Uniform RMSNorm weight keeping post-norm activations identical
        to the calibrated E=256 circuit (see W_OUT_SCALE comment)."""
        return float(np.sqrt(E / self.hidden_size))

    def model_config(self) -> ModelConfig:
        return ModelConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            rope_theta=self.rope_theta,
            rope_precise=self.rope_precise,
            max_position_embeddings=self.max_position_embeddings,
            attention_bias=True,
        )


BASE_SPEC = CircuitSpec()

# LP-optimized over every integer separation in [0, 4194304] — the same
# amps are minimax-optimal for both offsets (design_long_circuit.py):
# min margin 0.1656 (at D=57951 / D=754675), noise mass 1.2e-5 at
# lambda_pos=100 under 0.02-kernel-unit INT4 score noise.
_LONG_AMPS = (
    0.34704, 0.08182, 0.06386, 0.06070, 0.06519, 0.06706, 0.04986,
    0.05106, 0.03195, 0.03456, 0.04633, 0.02584, 0.01885, 0.02718,
    0.02870,
)

LONG_SPEC = CircuitSpec(
    rope_theta=1e14,
    max_position_embeddings=4_194_304,
    rope_precise=True,
    # all 16 slow pairs: at theta=1e14 even pair 16 drifts only 0.42 rad
    # over 4.2M (avg retention >= 0.99, worst single-pair-concentrated
    # code 0.91 -> matched 36.5 nats, still > the 30-nat sink). The
    # 14-pair (28-dim) variant measurably loses decode margin under
    # stacked W8A8+INT4-KV noise (codes carry 14% more per-dim energy),
    # flipping ~1/8 retrievals at 2k ctx; 32-dim codes do not.
    match_pairs=tuple(range(16, 32)),
    pos_amps=_LONG_AMPS,
)

LONG_8B_SPEC = CircuitSpec(
    rope_theta=1e14,
    max_position_embeddings=4_194_304,
    rope_precise=True,
    # The 32 slow pairs of the 128-dim head: inv_freq[p] = theta^(-p/64),
    # so p >= 32 drifts <= theta^(-1/2) * 4.2e6 = 0.42 rad over the 4.2M
    # design range — the same worst-pair drift LONG_SPEC's pair 16 has at
    # D=64. 32 pairs -> 64-dim match codes (even more per-dim margin
    # under stacked W8A8+INT4 noise than LONG_SPEC's validated 32 dims).
    match_pairs=tuple(range(32, 64)),
    # Even pairs 0,2,..,28 of the 128-dim head have EXACTLY the
    # frequencies of LONG_SPEC's pairs 0..14 (theta^(-2k/128) =
    # theta^(-k/32)), so the LP-minimax amplitudes carry over verbatim
    # with the same 0.1656 margin over every separation in [0, 4.2M].
    pos_amps=_LONG_AMPS,
    pos_pairs=tuple(range(0, 30, 2)),
    # full Llama-3-8B geometry (config.LLAMA3_8B_1048K shapes)
    hidden_size=4096,
    head_dim=128,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    intermediate_size=14336,
    vocab_size=128256,
    # digits "1".."16" are emittable (LongBench retrieval_score family);
    # fits: 64-dim codes (32 match pairs), 63+BOS signature rows
    num_digits=16,
)

CONSTRUCTED_LM = BASE_SPEC.model_config()
CONSTRUCTED_LM_LONG = LONG_SPEC.model_config()

# CPU-sized twin of LONG_8B_SPEC's novel structure (wide host + norm
# trick, head_dim 128, GQA query-slot mapping, pass-through layers,
# digit vocabulary) — exercises every 8B-graft mechanism in seconds.
SMALL_D128_SPEC = CircuitSpec(
    rope_theta=1e14,
    max_position_embeddings=4_194_304,
    rope_precise=True,
    match_pairs=tuple(range(32, 64)),
    pos_amps=_LONG_AMPS,
    pos_pairs=tuple(range(0, 30, 2)),
    hidden_size=512,
    head_dim=128,
    num_layers=4,
    num_heads=8,
    num_kv_heads=4,
    intermediate_size=128,
    vocab_size=512,
    circuit_layers=(1, 2),
    num_digits=16,
)

SPECS = {
    "constructed": BASE_SPEC,
    "constructed-long": LONG_SPEC,
    "constructed-8b": LONG_8B_SPEC,
    "constructed-d128": SMALL_D128_SPEC,
}


def ground_truth_heads(spec: CircuitSpec = BASE_SPEC) -> np.ndarray:
    """[num_layers, num_kv_heads] gate matrix of the KNOWN head types:
    the induction layer's two circuit KV heads are retrieval (1.0),
    everything else is streaming (0.0)."""
    heads = np.zeros((spec.num_layers, spec.num_kv_heads))
    heads[spec.circuit_layers[1], 0:2] = 1.0
    return heads


def spec_for(model_name: str) -> CircuitSpec:
    """CLI-name -> spec ('constructed' | 'constructed-long')."""
    return SPECS[model_name]


def _inv_freq(spec: CircuitSpec) -> np.ndarray:
    Dh = spec.head_dim
    return 1.0 / (
        spec.rope_theta ** (np.arange(0, Dh, 2, dtype=np.float64) / Dh)
    )


def _positional_qk(offset: int, spec: CircuitSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Bias vectors whose post-RoPE score peaks exactly at j = i - offset.

    Per rotation pair p: q_p = (a, 0), k_p = R(w_p * offset)(a, 0), so
    score(i, j) = sum_p a^2 cos(w_p (j - i + offset)) — a Dirichlet-style
    kernel with its maximum at j = i - offset. Fast pairs only (slow pairs
    stay zero for the matching heads to use)."""
    w = _inv_freq(spec)
    Dh = spec.head_dim
    bq = np.zeros(Dh)
    bk = np.zeros(Dh)
    for p, amp in zip(spec.positional_pairs, spec.pos_amps):
        bq[p] = amp
        bk[p] = np.cos(w[p] * offset)
        bk[p + Dh // 2] = np.sin(w[p] * offset)
    return bq, bk


def _orthonormal_rows(n: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((dim, dim))
    q, _ = np.linalg.qr(m)
    assert n <= dim
    return q[:n]


class Signatures:
    """Token-id keyed signature tables for a given tokenizer.

    Residual-stream match signatures are orthonormal in the FULL 64-dim
    subspaces (47 tokens + up to 16 digits <= 64 dims); each induction
    head projects just the token subset it matches on (names+is: 21,
    codes [+digits]: 26+) into its own code_dim rotation-slow q/k dims.

    ``num_digits`` > 0 appends digit tokens "1".."N" as extra emittable
    code tokens (see CircuitSpec.num_digits). Digit rows are APPENDED to
    every basis, so the original 47 token signatures are unchanged; only
    the BOS row index moves (no committed artifact depends on it at
    num_digits > 0 — the 0 default is bit-identical to before)."""

    def __init__(self, tokenizer, num_digits: int = 0):
        enc = lambda w: tokenizer.encode(" " + w, add_bos=False)  # noqa: E731
        self.name_ids = [self._one(enc, w) for w in _NAMES]
        self.code_ids = [self._one(enc, w) for w in _CODE_WORDS]
        self.is_id = self._one(enc, "is")
        self.dot_id = tokenizer.encode(".", add_bos=False)[-1]
        self.digit_ids = [
            self._one(enc, str(d)) for d in range(1, num_digits + 1)
        ]
        # digits behave exactly like code words downstream (retrieved by
        # the bigram head, chained by the continuation head)
        self.emit_ids = self.code_ids + self.digit_ids

        ids = self.name_ids + self.code_ids + [self.is_id] + self.digit_ids
        assert len(set(ids)) == len(ids), "token-id collision in vocab"
        assert len(ids) + 1 <= 64, "signature basis exceeds the A subspace"
        basis = _orthonormal_rows(len(ids) + 1, 64, seed=0)
        self.match = {tid: basis[i] for i, tid in enumerate(ids)}
        # BOS flag (orthogonal to every match signature): the induction
        # heads' no-match attention sink
        self.bos_sig = basis[len(ids)]
        # C's last two dims are embedding hooks (const + "."), so output
        # signatures live in its first 62 dims
        ob = _orthonormal_rows(len(self.emit_ids) + 1, 62, seed=1)
        out_basis = np.pad(ob, ((0, 0), (0, 2)))
        self.out = {tid: out_basis[i] for i, tid in enumerate(self.emit_ids)}
        self.out[self.dot_id] = out_basis[-1]

    @staticmethod
    def _one(enc, w):
        ids = enc(w)
        assert len(ids) == 1, (w, ids)
        return ids[0]


def slow_embed(sig: np.ndarray, spec: CircuitSpec) -> np.ndarray:
    """Place a code_dim code on the spec's slow pairs of a head_dim head
    (first components = the pairs' cos dims, second = their sin dims)."""
    pairs = np.asarray(spec.match_pairs)
    n = len(pairs)
    v = np.zeros(spec.head_dim)
    v[pairs] = sig[:n]
    v[pairs + spec.head_dim // 2] = sig[n:]
    return v


def _build_embed_np(sig: Signatures, spec: CircuitSpec) -> np.ndarray:
    """Embedding: match signature of known tokens into subspace A."""
    Eh = spec.hidden_size
    const_dim = C.start + 62  # embedding hooks parked in C's spare dims
    dot_dim = C.start + 63    # (C is empty until layer 1 writes it)
    embed = np.zeros((spec.vocab_size, Eh), np.float32)
    for tid, s in sig.match.items():
        embed[tid, A] = s
    embed[1, A] = sig.bos_sig  # BOS (ByteTokenizer/WordTokenizer id 1)
    # give every token a small constant component outside the signature
    # dims so no position has an all-zero residual (RMSNorm stability)
    embed[:, const_dim] += 0.05
    embed[sig.dot_id, dot_dim] = 1.0  # the "." output hook
    return embed


def _build_lm_head_np(sig: Signatures, spec: CircuitSpec) -> np.ndarray:
    """lm_head: read C with the output signatures."""
    lm_head = np.zeros((spec.hidden_size, spec.vocab_size), np.float32)
    for tid, o in sig.out.items():
        lm_head[C, tid] = o * spec.lambda_out
    return lm_head


def _layer_shapes(spec: CircuitSpec) -> Dict[str, Tuple[int, ...]]:
    """Each layer leaf's shape in the JAX package's layout ([in, out])."""
    Eh, Dh = spec.hidden_size, spec.head_dim
    Hq, Hkv, I = spec.num_heads, spec.num_kv_heads, spec.intermediate_size
    return {
        "input_norm": (Eh,), "post_norm": (Eh,),
        "wq": (Eh, Hq * Dh), "wk": (Eh, Hkv * Dh), "wv": (Eh, Hkv * Dh), "wo": (Hq * Dh, Eh),
        "bq": (Hq * Dh,), "bk": (Hkv * Dh,), "bv": (Hkv * Dh,),
        "w_gate": (Eh, I), "w_up": (Eh, I), "w_down": (I, Eh),
    }


def _zeros_layer_np(spec: CircuitSpec) -> Dict:
    """Host-shaped all-zero layer: with zero attention-output and MLP
    weights the layer is an EXACT residual pass-through — the engine
    still runs its full-cost GEMMs/attention/KV like any real layer."""
    return {k: (np.full(shape, spec.norm_scale, np.float32) if k.endswith("_norm")
                else np.zeros(shape, np.float32))
            for k, shape in _layer_shapes(spec).items()}


def _build_circuit_layers_np(
    sig: Signatures, spec: CircuitSpec
) -> Tuple[Dict, Dict]:
    """The two functional layers (local heads, induction heads), numpy.

    Under GQA the two functional heads per layer use QUERY slots 0 and G
    (G = query heads per KV head) so they map onto KV heads 0 and 1; the
    other query heads of those groups keep zero output weights (their
    attention patterns are computed but contribute nothing)."""
    Eh, Dh = spec.hidden_size, spec.head_dim
    G = spec.num_heads // spec.num_kv_heads
    dot_dim = C.start + 63

    def qslot(fn_idx):  # query-channel slice of functional head fn_idx
        h = fn_idx * G
        return slice(h * Dh, (h + 1) * Dh)

    def kvslot(fn_idx):
        return slice(fn_idx * Dh, (fn_idx + 1) * Dh)

    # values are 64-dim signatures; they ride in the first 64 dims of the
    # (possibly wider) value head — v is not rotated, so any fixed dims do
    def qv64(fn_idx):
        h = fn_idx * G
        return slice(h * Dh, h * Dh + 64)

    def kv64(fn_idx):
        return slice(fn_idx * Dh, fn_idx * Dh + 64)

    # ---- local layer: previous-token heads (offsets 1 and 2) ----
    l0 = _zeros_layer_np(spec)
    for head, (offset, dst) in enumerate([(1, B1), (2, B2)]):
        bq, bk = _positional_qk(offset, spec)
        scale = spec.lambda_pos * np.sqrt(Dh)  # undo 1/sqrt(D) in attention
        l0["bq"][qslot(head)] = bq * scale
        l0["bk"][kvslot(head)] = bk
        # v: read the A-subspace signature of the attended token
        l0["wv"][A, kv64(head)] = np.eye(64)
        # o: write it into the destination subspace (rebalanced)
        l0["wo"][qv64(head), dst] = np.eye(64) * W_OUT_SCALE

    # ---- induction layer ----
    l1 = _zeros_layer_np(spec)
    s = spec.lambda_match * np.sqrt(Dh)
    cdim = spec.code_dim

    def put_match(mat_eD, src_slice, sig64_rows, code_rows, weight):
        """mat[src-subspace signature -> code_dim slow code of the head]."""
        for r in range(sig64_rows.shape[0]):
            src = np.zeros(Eh)
            src[src_slice] = sig64_rows[r]
            mat_eD += np.outer(src, slow_embed(code_rows[r], spec)) * weight
        return mat_eD

    # head 0 — bigram ({name}, "is"): q = [is?(token_i) from A,
    # name-sig(token_{i-1}) from B1]; k = [is?(B1_j), name-sig(B2_j)]
    is_name_sigs = np.stack(
        [sig.match[sig.is_id]] + [sig.match[t] for t in sig.name_ids]
    )  # [21, 64]
    codes0 = _orthonormal_rows(len(is_name_sigs) + 1, cdim, seed=2)
    q0 = put_match(np.zeros((Eh, Dh)), A, is_name_sigs[:1], codes0[:1], s)
    q0 = put_match(q0, B1, is_name_sigs[1:21], codes0[1:21], s)
    k0 = put_match(np.zeros((Eh, Dh)), B1, is_name_sigs[:1], codes0[:1], 1.0)
    k0 = put_match(k0, B2, is_name_sigs[1:21], codes0[1:21], 1.0)
    # BOS sink: constant query component (bias) meets the BOS key. Keyed
    # off B1 (layer-0 self-attention at position 0 copies bos_sig there
    # with ~16x magnitude) — keying off A fails because RMSNorm shrinks
    # BOS's raw embedding to ~0.7 once B1/B2 fill up (measured).
    k0 = put_match(k0, B1, sig.bos_sig[None], codes0[-1:], 1.0)
    l1["wq"][:, qslot(0)] = q0
    l1["wk"][:, kvslot(0)] = k0
    l1["bq"][qslot(0)] = slow_embed(codes0[-1], spec) * (
        spec.lambda_sink * np.sqrt(Dh) / EXPECTED_KEY_NORM
    )

    # head 1 — unigram code continuation: q = code-sig(token_i) from A,
    # k = code-sig(B1_j); covers digits too when the spec enables them
    code_sigs = np.stack([sig.match[t] for t in sig.emit_ids])
    codes1 = _orthonormal_rows(len(code_sigs) + 1, cdim, seed=3)
    q1 = put_match(np.zeros((Eh, Dh)), A, code_sigs, codes1[:-1], s)
    k1 = put_match(np.zeros((Eh, Dh)), B1, code_sigs, codes1[:-1], 1.0)
    k1 = put_match(k1, B1, sig.bos_sig[None], codes1[-1:], 1.0)
    l1["wq"][:, qslot(1)] = q1
    l1["wk"][:, kvslot(1)] = k1
    l1["bq"][qslot(1)] = slow_embed(codes1[-1], spec) * (
        spec.lambda_sink * np.sqrt(Dh) / EXPECTED_KEY_NORM
    )

    # both heads: v reads the OUTPUT signature of token_j (translating
    # A's match signature / the "." hook), o writes into C
    v_read = np.zeros((Eh, 64))
    for tid in sig.emit_ids:
        src = np.zeros(Eh)
        src[A] = sig.match[tid]
        v_read += np.outer(src, sig.out[tid])
    dot_src = np.zeros(Eh)
    dot_src[dot_dim] = 1.0
    v_read += np.outer(dot_src, sig.out[sig.dot_id])
    for head in (0, 1):
        l1["wv"][:, kv64(head)] = v_read
        l1["wo"][qv64(head), C] = np.eye(64) * W_OUT_SCALE
    return l0, l1


def _layers_np(sig: Signatures, spec: CircuitSpec):
    """Yield (index, numpy layer dict) for every host layer."""
    l0, l1 = _build_circuit_layers_np(sig, spec)
    placed = {spec.circuit_layers[0]: l0, spec.circuit_layers[1]: l1}
    for li in range(spec.num_layers):
        yield li, placed.get(li) or _zeros_layer_np(spec)


def build_params(tokenizer, dtype=torch.float32, spec: CircuitSpec = BASE_SPEC,
                 device="cuda") -> Dict:
    """The full params dict in ``dtype`` on ``device`` (the card unless the
    caller asks for the CPU): the numpy construction in the JAX layout, then
    ``params_from_numpy``."""
    assert spec.hidden_size >= E, "circuit needs the first 256 hidden dims"
    sig = Signatures(tokenizer, num_digits=spec.num_digits)
    tree = {
        "embed": _build_embed_np(sig, spec),
        "final_norm": np.full(spec.hidden_size, spec.norm_scale, np.float32),
        "lm_head": _build_lm_head_np(sig, spec),
        "layers": [layer for _, layer in _layers_np(sig, spec)],
    }
    return params_from_numpy(tree, device=device, dtype=dtype)


def _quantized_layer(layer_np: Dict, dev) -> Dict:
    """A numpy layer (JAX layout) in the W8A8 form: each projection goes to
    the device in float32, takes the port's layout there and is quantized per
    output channel (``ops.quant.quantize_weight_int8``, bitwise the JAX
    package's numpy twin); norms and biases ride bf16."""
    out = {}
    for k, v in layer_np.items():
        if k in QUANTIZED_PROJECTIONS:
            out[k + "_q8"], out[k + "_scale"] = quantize_weight_int8(
                leaf_from_numpy(k, v, dev, torch.float32))
        else:
            out[k] = leaf_from_numpy(k, v, dev, torch.bfloat16)
    return out


def _passthrough_layer(spec: CircuitSpec, dev) -> Dict:
    """An all-zero layer in the W8A8 form, allocated on ``dev``: int8 zeros,
    weight scales of 1e-12 (the numpy twin's scale of a zero column), norms
    of ``spec.norm_scale`` and zero biases in bf16. Every call makes its own
    buffers."""
    out = {}
    for k, shape in _layer_shapes(spec).items():
        if k in QUANTIZED_PROJECTIONS:
            out_f, in_f = shape[1], shape[0]  # the port's [out, in]
            out[k + "_q8"] = torch.zeros((out_f, in_f), dtype=torch.int8, device=dev)
            out[k + "_scale"] = torch.full((out_f,), 1e-12, dtype=torch.float32, device=dev)
        elif k.endswith("_norm"):
            out[k] = torch.full(shape, spec.norm_scale, dtype=torch.bfloat16, device=dev)
        else:
            out[k] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    return out


def build_params_w8a8(tokenizer, spec: CircuitSpec = LONG_8B_SPEC, quantize_embeds: bool = True,
                      device="cuda") -> Dict:
    """Construct the circuit directly in the W8A8 serving form on ``device``.

    The float32 8B-geometry params would take ~23 GB, so nothing holds them:
    the two circuit layers are built in numpy and quantized on the device one
    leaf at a time, and each pass-through layer is allocated there with its
    OWN buffers (``_passthrough_layer``; none shared), so the device footprint
    and the weight reads equal a real checkpoint's (7.5 GiB at 8B, as
    ``ops.quant.init_params_w8a8_random``). The float32 embedding and head go
    to the device, are quantized per row there (as the JAX build's numpy
    code quantizes them) and are freed. The int8 tables and scales equal the
    JAX package's ``build_params_w8a8`` bit for bit."""
    assert spec.hidden_size >= E, "circuit needs the first 256 hidden dims"
    dev = resolve_device(device)
    sig = Signatures(tokenizer, num_digits=spec.num_digits)
    placed = {li: _quantized_layer(layer, dev)
              for li, layer in zip(spec.circuit_layers, _build_circuit_layers_np(sig, spec))}
    layers = [placed.get(li) or _passthrough_layer(spec, dev) for li in range(spec.num_layers)]
    params = {"layers": layers,
              "final_norm": torch.full((spec.hidden_size,), spec.norm_scale, dtype=torch.bfloat16, device=dev)}
    for name, build in (("embed", _build_embed_np), ("lm_head", _build_lm_head_np)):
        table = leaf_from_numpy(name, build(sig, spec), dev, torch.float32)  # [vocab, E] either way
        if quantize_embeds:  # a scale per row: embed rows, lm_head output channels
            params[name + "_q8"], params[name + "_scale"] = quantize_weight_int8(table)
        else:
            params[name] = table
        del table
    return params
