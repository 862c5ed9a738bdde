"""Architecture config schema + input-shape sets (assigned grid).

A copy of the reference's ``repro/models/config.py``, field for field, so
that every config file of ``repro_torch.configs`` loads. The port serves
the dense, ssm and hybrid families; the other families' fields are kept as
data. ``param_count`` is the reference's analytic count (for roofline
math): it leaves out the SSM's dt_bias, a_log, d_skip, conv_w and
ssm_norm, and counts an ln2 that an arch without a feed-forward width
(mamba2) does not have."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # routed-expert width (fine-grained MoE)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # --- hybrid (hymba): parallel attn + ssm heads in every layer ---
    parallel_ssm: bool = False
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    # --- vlm stub (phi-3-vision): patch embeddings fill the first slots ---
    num_patches: int = 0
    # --- audio stub (whisper): frame embeddings replace encoder tokens ---
    frame_input: bool = False
    dtype: str = "bfloat16"
    # vocab padding multiple: keeps the embedding/vocab dim divisible by any
    # mesh "model" axis (padded ids are never targets)
    pad_vocab_to: int = 2048
    # activation-checkpoint policy for the layer scan (perf lever, §Perf):
    #   "full"      — recompute everything in backward (min memory)
    #   "save_dots" — save matmul outputs, recompute elementwise only
    #   "none"      — save all residuals (max memory, min recompute)
    remat_policy: str = "full"
    # EXACT structural padding (perf levers, §Perf): padded q heads have
    # zero wo rows, padded kv heads zero wk/wv columns, padded experts are
    # never routed — all provably inert and gradient-stable (see §Perf).
    # They exist to make the head/expert axes divisible by the mesh "model"
    # axis, eliminating GSPMD resharding storms.
    pad_q_heads_to: int = 0
    pad_kv_heads_to: int = 0
    pad_experts_to: int = 0
    # §Perf levers (off = paper-faithful baseline):
    # cast f32 master weights to compute dtype ONCE outside the layer scan,
    # so GSPMD gathers bf16 (half the collective bytes) instead of f32
    cast_weights_once: bool = False
    # shard the input embedding on d_model instead of vocab (untied archs):
    # token lookup becomes local instead of an all-gather of the table
    embed_d_shard: bool = False
    # pin q/k/v/o activation shardings in attention to
    # (batch_axes, None, "model", None) — stops GSPMD's seq-resharding
    # wander inside the chunked-attention loops (launcher supplies axes)
    shard_attn: bool = False

    @property
    def q_heads_eff(self) -> int:
        return max(self.num_heads, self.pad_q_heads_to)

    @property
    def kv_heads_eff(self) -> int:
        return max(self.num_kv_heads, self.pad_kv_heads_to)

    @property
    def experts_eff(self) -> int:
        return max(self.num_experts, self.pad_experts_to)

    @property
    def vocab_padded(self) -> int:
        m = max(self.pad_vocab_to, 1)
        return -(-self.vocab_size // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM state keeps decode O(1)-ish)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads * 2 + self.num_kv_heads * 2)
        mlp = 3 * d * f if f else 0
        moe = 0
        if self.num_experts:
            fe = self.moe_d_ff or f
            moe = (self.num_experts * 3 * d * fe
                   + self.num_shared_experts * 3 * d * fe
                   + d * self.num_experts)
            mlp = 0
        ssm = 0
        if self.has_ssm:
            d_in = self.ssm_heads * self.ssm_head_dim
            n = self.ssm_state
            ssm = d * (2 * d_in + 2 * n + self.ssm_heads) + d_in * d
        per_layer = 2 * d + mlp + moe
        if self.has_attention:
            per_layer += attn
        if self.has_ssm:
            per_layer += ssm
        total = self.num_layers * per_layer
        if self.is_encdec:  # encoder self-attn+mlp, decoder gets cross-attn
            total += self.encoder_layers * (2 * d + attn + 3 * d * f)
            total += self.num_layers * attn  # cross-attention
        total += self.vocab_padded * d * (1 if self.tie_embeddings else 2) + d
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (6*N_active*D)."""
        if not self.num_experts:
            return self.param_count()
        fe = self.moe_d_ff or self.d_ff
        active_moe = ((self.experts_per_token + self.num_shared_experts)
                      * 3 * self.d_model * fe + self.d_model
                      * self.num_experts)
        total_moe = (self.num_experts + self.num_shared_experts) * 3 \
            * self.d_model * fe + self.d_model * self.num_experts
        return self.param_count() - self.num_layers * (total_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
