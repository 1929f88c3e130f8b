"""Model / run configuration schema.

The port's copy of the JAX package's ``configs/base.py``, field for field
(it holds data only).  One ``ModelConfig`` instance per architecture lives
in ``repro_torch/configs/<arch>.py`` with the public-literature numbers;
reduced smoke variants are derived with ``.smoke()``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------
# Input-shape cells (assigned to every LM arch; registry.cells_for lists them).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity -------------------------------------------------------------
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    # backbone -------------------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // n_heads
    # attention features -----------------------------------------------------
    attn_type: str = "gqa"          # gqa | mla
    qk_norm: bool = False           # qwen3
    attn_softcap: float = 0.0       # gemma2 (30.0)
    final_softcap: float = 0.0      # gemma2 (50.0)
    sliding_window: int = 0         # >0: SWA window
    layer_pattern: str = "global"   # global | swa | alt_local_global
    post_norm: bool = False         # gemma2 post-block RMSNorm
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) dims
    # MLA (minicpm3 / deepseek-style) ---------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual_d_ff: int = 0    # arctic: parallel dense MLP
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_coef: float = 1e-2
    # SSM (mamba2 / SSD) ------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # hybrid (zamba2) ---------------------------------------------------------
    hybrid_units: int = 0           # units of (mamba_per_unit mamba + 1 shared attn)
    mamba_per_unit: int = 0
    trailing_mamba: int = 0
    shared_lora_rank: int = 0
    # enc-dec (seamless) ------------------------------------------------------
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_input_dim: int = 0          # stubbed modality frontend output dim
    src_len_for_decode: int = 4096  # encoder length used by decode cells
    # vlm ----------------------------------------------------------------------
    vision_embed_dim: int = 0       # stubbed patch-embedding dim
    # training / numerics -------------------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "full"             # none | full | dots
    optimizer: str = "adamw"        # adamw | adafactor
    tie_embeddings: bool = False
    microbatch: int = 1             # grad-accumulation splits of the global batch
    # attention chunking (flash-style scan) -------------------------------------
    q_chunk: int = 512
    k_chunk: int = 1024
    causal_mode: str = "masked"     # masked | triangular (perf lever, §Perf)
    replicate_kv: bool = False      # replicate K/V projections over the model
                                    # axis (perf lever: avoids head-dim
                                    # splitting when n_kv_heads < model axis)
    # serving -----------------------------------------------------------------
    max_cache_len: int = 32768
    kv_quant: str = "none"          # none | int8 — per-(token,head) symmetric
                                    # KV-cache quantization (serving lever;
                                    # supported for gqa dense/moe/vlm patterns)

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as the JAX package pads it
        so the table and the logits shard evenly (MaxText-style padding;
        labels never index the pad rows)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def n_params(self) -> float:
        """Approximate total parameter count (for roofline MODEL_FLOPS)."""
        d, L, hd = self.d_model, self.n_layers, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din = self.ssm_expand * d
            per = d * (2 * din + 2 * self.ssm_ngroups * self.ssm_state
                       + din // self.ssm_head_dim) + din * d
            return emb + L * per
        if self.family == "hybrid":
            din = self.ssm_expand * d
            n_mamba = self.hybrid_units * self.mamba_per_unit + self.trailing_mamba
            mamba = n_mamba * (d * (2 * din + 2 * self.ssm_ngroups * self.ssm_state
                                    + din // self.ssm_head_dim) + din * d)
            attn = (self.n_heads + 2 * self.n_kv_heads) * hd * d + \
                self.n_heads * hd * d + 3 * d * self.d_ff
            return emb + mamba + attn
        if self.attn_type == "mla":
            attn = d * self.q_lora_rank \
                + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim) \
                + d * (self.kv_lora_rank + self.qk_rope_dim) \
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim) \
                + self.n_heads * self.v_head_dim * d
        else:
            attn = (self.n_heads + 2 * self.n_kv_heads) * hd * d \
                + self.n_heads * hd * d
        if self.n_experts:
            ffn = 3 * d * self.moe_d_ff * self.n_experts + d * self.n_experts
            ffn += 3 * d * self.dense_residual_d_ff
        else:
            ffn = 3 * d * self.d_ff
        n_lay = (self.n_enc_layers + self.n_dec_layers) if self.is_encdec else L
        cross = self.n_dec_layers * ((self.n_heads + self.n_kv_heads) * hd * d
                                     + self.n_heads * hd * d) if self.is_encdec else 0
        return emb + n_lay * (attn + ffn) + cross

    def n_active_params(self) -> float:
        """Active params per token (MoE top-k) for MODEL_FLOPS of MoE archs."""
        if not self.n_experts:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        full = self.n_params()
        all_experts = L * 3 * d * self.moe_d_ff * self.n_experts
        active = L * 3 * d * self.moe_d_ff * self.experts_per_token
        return full - all_experts + active

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=128,
            q_chunk=32,
            k_chunk=32,
            max_cache_len=64,
            remat="none",
            dtype="float32",
        )
        if self.n_experts:
            kw.update(n_experts=4, experts_per_token=min(2, self.experts_per_token),
                      moe_d_ff=64,
                      dense_residual_d_ff=64 if self.dense_residual_d_ff else 0)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=16)
        if self.family == "hybrid":
            kw.update(hybrid_units=2, mamba_per_unit=2, trailing_mamba=1,
                      shared_lora_rank=4)
        if self.is_encdec:
            kw.update(n_enc_layers=2, n_dec_layers=2, enc_input_dim=64,
                      src_len_for_decode=32)
        if self.attn_type == "mla":
            kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16)
        if self.mrope_sections:
            kw.update(mrope_sections=(4, 2, 2))  # sums to head_dim//2 = 8
        if self.sliding_window:
            kw.update(sliding_window=32)
        kw.update(name=self.name + "-smoke")
        return ModelConfig(**kw)
