"""Model / run configuration (port of ``repro.configs.base``).

:class:`ModelConfig` and :class:`ShapeSpec` are copies of the reference's
framework-neutral dataclasses (the port imports nothing of ``repro``).
:class:`RunConfig` keeps the reference's knobs, with torch dtypes, and
``SHAPES`` its four shape cells.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio",
                 "cnn"]

#: valid values of :attr:`RunConfig.fusion` (same list as the reference)
FUSION_MODES = ("off", "static", "auto", "measured")
AMP_MODES = ("O0", "O1", "O2")
ATTN_IMPLS = ("einsum", "chunked", "flash")
SSD_IMPLS = ("xla", "kernel")
REMAT_MODES = ("none", "dots", "full")
MOE_COMBINES = ("default", "reshard", "a2a")
OPTIMIZERS = ("adamw", "adafactor")
#: DeepCAM lowerings (the paper's TF-vs-PyTorch comparison)
IMPLS = ("reference", "fused")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    act: str = "swiglu"              # swiglu | geglu | gelu | relu2
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_shared_ff: int = 0
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # --- hybrid ---
    hybrid_group: int = 0
    # --- enc-dec ---
    n_encoder_layers: int = 0
    # --- multimodal stubs ---
    n_prefix_embeds: int = 0
    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and not self.n_kv_heads:
            object.__setattr__(self, "n_kv_heads", self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded to a multiple of 128; the padded
        logit columns are masked in the loss."""
        return (self.vocab_size + 127) // 128 * 128

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (the long-context cell applies)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding included), as the reference
        writes it (``repro.configs.base.ModelConfig.param_count``).

        The ``ssm`` and ``hybrid`` branches are the reference's counts,
        mirrored and not corrected: they take the embedding at
        ``vocab_size`` (not the padded table) and leave out ``dt_bias`` and
        ``conv_b``, so for ``mamba2-1.3b`` the count reads 1,343,528,960,
        261,120 below the 1,343,790,080 leaves of the spec tree.  The
        hybrid's also counts one pair of site norms (2·D) where the spec
        tree holds a pair for each site: for ``zamba2-1.2b`` it reads
        1,087,997,696, 183,424 below the 1,088,181,120 spec leaves
        (162,944 of ``dt_bias`` and ``conv_b``, 20,480 of site norms; 800
        below at the smoke size: 177,664 against 178,464).  Every family
        takes the embedding at ``vocab_size``, and ``encdec`` / ``audio``
        leave out the encoder's final norm, as the reference's do."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        total = V * D * (1 if self.tie_embeddings else 2)
        attn = (D * self.n_heads * self.head_dim
                + 2 * D * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * D)

        def mlp(ff: int) -> int:
            return (3 if self.act in ("swiglu", "geglu") else 2) * D * ff

        if self.family in ("dense", "vlm"):
            return total + L * (attn + mlp(F) + 2 * D) + D
        if self.family == "moe":
            return total + L * (attn + self.n_experts * mlp(F)
                                + D * self.n_experts          # router
                                + mlp(self.moe_shared_ff) + 2 * D) + D
        if self.family in ("encdec", "audio"):
            enc = self.n_encoder_layers * (attn + mlp(F) + 2 * D)
            dec = L * (2 * attn + mlp(F) + 3 * D)
            return total + enc + dec + D
        if self.family not in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"param_count for family {self.family!r}: the reference "
                "counts none")
        di, G, N = self.d_inner, self.ssm_n_groups, self.ssm_state
        H = self.ssm_heads
        ssm = (D * (2 * di + 2 * G * N + H)               # in_proj
               + self.ssm_conv_width * (di + 2 * G * N)   # conv_w
               + di * D                                   # out_proj
               + 2 * H + di)                              # A_log, D, norm
        total += L * (ssm + D)
        if self.family == "hybrid":
            total += attn + mlp(F) + 2 * D                # the shared block
        return total + D

    def active_param_count(self) -> int:
        """Parameters a token meets: a MoE layer's top-k experts, not all
        of them (the reference's, for 6·N_active·D); every other family's
        :meth:`param_count`."""
        if self.family != "moe":
            return self.param_count()
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        expert = mult * self.d_model * self.d_ff
        return (self.param_count()
                - self.n_layers * (self.n_experts
                                   - self.experts_per_token) * expert)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution policy.  The port runs every ``fusion`` mode (``"auto"`` /
    ``"measured"`` route by the measured dispatch table,
    ``repro_torch.tune.dispatch``), the ``einsum``, ``chunked`` and
    ``flash`` attention, the ``xla`` and ``kernel`` SSD scans, every
    ``remat`` mode, both DeepCAM lowerings (``impl``), AdamW and
    Adafactor, and the reference's three ``moe_combine`` values.

    Parallelism, as the reference's (``repro_torch.distributed.sharding``
    maps logical axes to mesh axes under these flags; they act only on
    tensors that are DTensors on a mesh):

    * ``tp``: Megatron tensor parallelism — heads, KV heads, ffn, expert
      ffn, SSM inner channels and vocab over the ``"model"`` mesh axis;
    * ``fsdp``: ZeRO-3 — each parameter's first free, divisible dim also
      over the data axes (``("pod", "data")`` on a multi-pod mesh);
    * ``sp``: sequence-sharded activations over ``"model"`` between
      blocks;
    * ``ep``: experts over ``"model"``;
    * ``sharded_logits``: the reference's vocab-sharded cross-entropy
      flag, kept for its records; the port's loss does not read it yet
      (on a mesh DTensor gathers the logits over the vocab);
    * ``grad_compression``: the reference's cross-pod int8 gradient
      compression flag, kept for its records; read by nothing, as in the
      reference (``repro_torch.distributed.compression`` is the scheme).
    """

    # O0 = fp32; O1 = bf16 compute / fp32 params; O2 = bf16 everywhere
    amp: str = "O1"
    # per-block activation checkpointing: "none" | "dots" (keep the
    # products against a weight, recompute the rest) | "full"
    remat: str = "none"
    # parallelism (see the docstring)
    tp: bool = True
    fsdp: bool = False
    sp: bool = False
    ep: bool = True
    # attention lowering: "einsum" | "chunked" (query chunks of attn_chunk,
    # recomputed in the backward) | "flash" (the hand-written kernel)
    attn_impl: str = "einsum"
    attn_chunk: int = 1024
    # SSD lowering: "xla" (the chunked dual form in torch ops) | "kernel"
    # (the hand-written ssd_scan kernel); the reference's names
    ssd_impl: str = "xla"
    # attention softmax statistics in fp32 (False = compute dtype)
    softmax_f32: bool = True
    fusion: str = "off"
    # logits: vocab-sharded cross-entropy without a full gather
    sharded_logits: bool = True
    # gradient accumulation microbatches
    microbatches: int = 1
    # cross-pod gradient compression (int8 + error feedback)
    grad_compression: bool = False
    # optimizer: "adamw" | "adafactor"
    optimizer: str = "adamw"
    # deepcam lowering: "reference" (every norm round-trips through fp32)
    # | "fused" (every norm folded into its conv)
    impl: str = "reference"
    # MoE combine: the reference's three values ("default", "reshard",
    # "a2a") differ only in the sharding constraints (``constrain``) they
    # put on the dispatch and combine buffers: the same function, moved
    # differently across a mesh (on one device all three are the same).
    moe_combine: str = "default"

    def __post_init__(self):
        if self.amp not in AMP_MODES:
            raise ValueError(f"unknown amp {self.amp!r}; valid: {AMP_MODES}")
        if self.fusion not in FUSION_MODES:
            raise ValueError(f"unknown fusion mode {self.fusion!r}; valid: "
                             f"{', '.join(FUSION_MODES)}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}; "
                             f"valid: {ATTN_IMPLS}")
        if self.ssd_impl not in SSD_IMPLS:
            raise ValueError(f"unknown ssd_impl {self.ssd_impl!r}; "
                             f"valid: {SSD_IMPLS}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat {self.remat!r}; "
                             f"valid: {REMAT_MODES}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; "
                             f"valid: {OPTIMIZERS}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; valid: {IMPLS}")
        if self.moe_combine not in MOE_COMBINES:
            raise ValueError(f"unknown moe_combine {self.moe_combine!r}; "
                             f"valid: {MOE_COMBINES}")
        if self.attn_chunk < 1:
            raise ValueError(f"attn_chunk must be >= 1, got "
                             f"{self.attn_chunk}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got "
                             f"{self.microbatches}")

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.float32 if self.amp in ("O0", "O1") else torch.bfloat16

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32 if self.amp == "O0" else torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
