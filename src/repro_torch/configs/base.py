"""Config dataclasses: model architecture + SPT (paper technique) knobs.

Field-for-field mirror of the JAX package's ``configs/base.py`` with torch
dtypes, so a config written for one package carries over to the other
(tests/test_torch_package.py asserts the field names match).  The switch
values keep their JAX meaning; ``"pallas"`` selects the hand-written Hopper
kernel here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.lora import LoRAConfig


@dataclasses.dataclass(frozen=True)
class SPTConfig:
    """Paper-technique configuration (defaults = paper defaults)."""
    sparse_mha: bool = True
    routed_ffn: bool = True
    lora: LoRAConfig = LoRAConfig(rank=16, alpha=16.0, enabled=True)
    # sparse MHA (§4.1): keep top-L = top_fraction * n attention weights
    attn_top_fraction: float = 0.125
    attn_min_l: int = 16
    attn_pad_l_to: int = 1
    pq_code_dim: int = 8            # d' (paper §5.1)
    pq_codewords: int = 16          # E (paper §5.1)
    pq_update_interval: int = 20
    select_granularity: str = "qhead"   # "kvgroup" = GQA-shared selection
    chunk_q: int = 256
    attn_impl: str = "sparse_jnp"   # sparse_jnp | sparse_masked | pallas
    # decode attention: "kernel" = fused CUDA decode kernel, "jnp" = the
    # core/ oracle, "auto" = kernel iff attn_impl == "pallas".
    decode_attn_impl: str = "auto"  # auto | kernel | jnp
    # sparse decode kernel tier: "fused" = one pass (kernel 6 / 7),
    # "two_pass" = thresholds then attention (kernels 3 and 5)
    decode_attn_fuse: str = "auto"  # auto | fused | two_pass
    # paged decode: "kernel" = kernels 7 / 8 through the page table,
    # "gather" = decode over gathered per-slot views, "auto" = follow
    # attn_impl ("pallas" = kernel)
    kv_paged_native: str = "auto"   # auto | kernel | gather
    # routed FFN (§4.2): G groups, G' active (beta = G'/G)
    ffn_groups: int = 8
    ffn_active_groups: int = 4
    ffn_capacity_factor: float = 1.25
    dispatch_pad: int = 8
    # "pallas" = grouped-FFN CUDA kernel with in-kernel token gather;
    # "grouped" = the core/ capacity path; REPRO_DISABLE_KERNELS=1
    # demotes "pallas" to "grouped".
    ffn_impl: str = "grouped"       # grouped | dense | pallas
    # decode routed FFN at (B, 1, d): "kernel" = block-gather CUDA kernel,
    # "jnp" = the grouped capacity path, "auto" = follow ffn_impl.
    decode_ffn_impl: str = "auto"   # auto | kernel | jnp
    kv_layout: str = "contiguous"   # contiguous | paged
    kv_page_size: int = 128         # rows per KV page
    routed_ffn_in_experts: bool = False
    lb_loss_weight: float = 0.01
    qerr_loss_weight: float = 0.0
    # serving observability (serving/telemetry.py): "off" adds no counter
    # work to the decode chunk; "counters" accumulates device counters
    # (sparse-MHA kept/eligible slots, routed-FFN expert loads and drops,
    # pages grown, sampled tokens) and drains them at the chunk's one host
    # sync; "trace" adds the host-side request/scheduler event timeline
    telemetry: str = "off"          # off | counters | trace

    def disabled(self) -> "SPTConfig":
        return dataclasses.replace(self, sparse_mha=False, routed_ffn=False)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    pattern: Tuple[str, ...] = ("attn",)
    activation: str = "silu"
    gated_ffn: bool = True         # SwiGLU/GeGLU
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: Optional[float] = 10000.0
    positional: str = "rope"       # rope | learned | none
    max_position: int = 1 << 20
    window: Optional[int] = None   # sliding-window attention
    logits_softcap: Optional[float] = None
    tie_embeddings: bool = False
    scale_embed: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 2
    moe_capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    # recurrent (RG-LRU)
    lru_width: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend (stub)
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    # numerics
    dtype: torch.dtype = torch.bfloat16
    # the paper's technique
    spt: SPTConfig = SPTConfig()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:      # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the JAX param layout)."""
        return -(-self.vocab_size // 256) * 256

    def layer_types(self) -> Tuple[str, ...]:
        """The block kind of each layer: the pattern repeated, cut to
        num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.num_layers])

    def with_spt(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, spt=dataclasses.replace(self.spt, **kw))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape regime of an arch (a cell of the JAX dry run)."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", 4096, 256),
    ShapeSpec("prefill_32k", "prefill", 32768, 32),
    ShapeSpec("decode_32k", "decode", 32768, 128),
    ShapeSpec("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
