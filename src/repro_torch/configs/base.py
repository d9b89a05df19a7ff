"""Config system: model / shape / mesh / train dataclasses and the
registry.

The port's copy of the reference's ``configs/base.py``. Every
architecture in ``src/repro_torch/configs/<id>.py`` exports ``CONFIG``, a
``ModelConfig``; the fields, defaults and parameter counts are the
reference's. Shapes (the assigned input-shape sets) are global and keyed
by name; ``supported_shapes`` says which of them an arch runs.
``resolve(arch, shape)`` returns a fully-bound ``RunConfig``. A
``MeshConfig`` describes the production mesh (shape and axis names); the
devices of a mesh the port runs on are a ``sharding.mesh.DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned): seq_len x global_batch cells.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm' | 'filter'
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    # attention structure
    attn_window: int = 0           # 0 = full attention; >0 = sliding window
    global_every: int = 0          # e.g. 6 -> every 6th layer is global (gemma3 5:1)
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) splits
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False      # gemma-style sqrt(d) embedding scaling
    attn_logit_softcap: float = 0.0
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0              # expert hidden size (qwen3-moe: 768)
    capacity_factor: float = 1.25
    moe_force_ep: bool = False     # EP mesh: E-sharded expert weights
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    mamba_heads: int = 0           # hymba: number of mamba heads in parallel
    slstm_every: int = 0           # xlstm: every k-th layer is sLSTM (7:1 -> 8)
    num_meta_tokens: int = 0       # hymba learnable prefix tokens
    # enc-dec (whisper)
    encoder_layers: int = 0
    max_target_positions: int = 0  # whisper decoder learned positions (448)
    # frontend stubs: inputs are embeddings, not token ids
    embeddings_in: bool = False
    # spatial-filter ("the paper's own" config)
    filter_window: int = 0
    image_h: int = 0
    image_w: int = 0
    image_c: int = 0
    # analysis / tuning knobs
    kv_cache_dtype: str = ""       # '' = model dtype; 'int8' = quantised KV
    use_pallas_attn: bool = False  # banded flash kernel for train/prefill
    q_chunk: int = 1024            # attend() q chunking (0 = off)
    ssd_chunk: int = 256           # mamba SSD chunk
    stage_override: Tuple[Tuple[str, int, int], ...] = ()
    #   ((kind, window, count), ...) — roofline per-class lowerings
    # misc
    dtype: str = "bfloat16"
    notes: str = ""

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    # -- parameter counting (for MODEL_FLOPS = 6 N D) ------------------------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim()
    q = cfg.d_model * cfg.num_heads * hd
    kv = 2 * cfg.d_model * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * cfg.d_model
    return q + kv + o


def _dense_mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    # gated (SwiGLU-style): wi, wg, wo
    return 3 * cfg.d_model * d_ff


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count per family (embedding included once)."""
    d, v = cfg.d_model, cfg.vocab_size
    embed = d * v * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "filter":
        return cfg.filter_window ** 2
    if cfg.family == "ssm":  # xlstm
        return embed + cfg.num_layers * _xlstm_layer_params(cfg)
    per_layer = 0
    if cfg.family in ("dense", "vlm"):
        per_layer = _attn_params(cfg) + _dense_mlp_params(cfg, cfg.d_ff)
    elif cfg.family == "moe":
        e = cfg.num_experts_per_tok if active_only else cfg.num_experts
        eff = cfg.moe_d_ff or cfg.d_ff
        per_layer = _attn_params(cfg) + e * 3 * d * eff + d * cfg.num_experts
    elif cfg.family == "hybrid":
        per_layer = (_attn_params(cfg) + _mamba_params(cfg)
                     + _dense_mlp_params(cfg, cfg.d_ff))
    elif cfg.family == "encdec":
        enc = cfg.encoder_layers * (_attn_params(cfg) + 2 * d * cfg.d_ff)
        dec = cfg.num_layers * (2 * _attn_params(cfg) + 2 * d * cfg.d_ff)
        return embed + enc + dec
    norms = 2 * d * cfg.num_layers
    return embed + cfg.num_layers * per_layer + norms


def _mamba_params(cfg: ModelConfig) -> int:
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    return (2 * cfg.d_model * d_in          # in_proj (x, z)
            + d_in * cfg.ssm_conv_width     # depthwise conv
            + d_in * (2 * n + 2)            # B, C, dt projections (folded)
            + d_in * n                      # A
            + d_in * cfg.d_model)           # out proj


def _xlstm_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    pf = 2
    d_in = pf * d
    # mLSTM block approx: up/gate/down proj + qkv + gates
    return 3 * d * d_in + 3 * d_in * d_in // max(cfg.num_heads, 1) + 4 * d_in


# ---------------------------------------------------------------------------
# Mesh / parallelism config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axis_names

    def num_devices(self) -> int:
        return math.prod(self.shape)

    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Train config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: int = 0            # 0 = no accumulation
    remat_policy: str = "full"     # 'none' | 'full' | 'dots' | 'dots_with_no_batch'
    loss_chunk: int = 2048         # chunked-vocab CE chunk along seq
    z_loss: float = 0.0
    grad_compression: str = "none"  # 'none' | 'int8_ef' (pod axis)
    param_dtype: str = "float32"
    seed: int = 0


# ---------------------------------------------------------------------------
# RunConfig: everything bound together
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """A model bound to a shape, a mesh and a train config, with the
    reference's fields. The reference's ``mesh`` has no default; the
    port's defaults to ``SINGLE_POD``, the mesh ``resolve`` binds unless
    ``multi_pod``, so that a ``RunConfig(model=, shape=)`` of one device
    still builds. ``sharding_profile`` names a profile of
    ``sharding.rules``. The reference's ``use_pallas`` is not carried: it
    picks the Pallas path of its dry run, and the port's kernels are
    picked by each call's device."""
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD
    train: TrainConfig = TrainConfig()
    sharding_profile: str = "default"  # see sharding/rules.py

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "qwen2_vl_7b",
    "gemma3_4b",
    "h2o_danube_1_8b",
    "yi_6b",
    "codeqwen15_7b",
    "xlstm_350m",
    "hymba_1_5b",
    "mixtral_8x7b",
    "qwen3_moe_30b_a3b",
    "whisper_large_v3",
]

PAPER_ARCH = "spatial_filter_hd"


def get_model_config(arch: str) -> ModelConfig:
    import importlib

    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS and arch != PAPER_ARCH:
        raise ValueError(f"no config {arch!r}; the port carries {ARCH_IDS} "
                         f"and {PAPER_ARCH!r}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def supported_shapes(model: ModelConfig) -> Sequence[str]:
    """Which assigned shapes run for this arch (the reference's rule: no
    LM shape for the filter config; long_500k only where attention is
    sub-quadratic: SSM / hybrid, or a sliding window outside enc-dec)."""
    if model.family == "filter":
        return ()
    shapes = ["train_4k", "prefill_32k"]
    # enc-dec has a decode step (cross-KV of seq_len); encoder-only would not.
    shapes.append("decode_32k")
    subquad = (model.family in ("ssm", "hybrid")
               or (model.attn_window > 0 and model.family not in ("encdec",)))
    if subquad:
        shapes.append("long_500k")
    return tuple(shapes)


def resolve(arch: str, shape: str, multi_pod: bool = False,
            **overrides: Any) -> RunConfig:
    """``RunConfig`` of ``arch`` at the assigned ``shape`` on the
    production mesh (``MULTI_POD`` where ``multi_pod``), with
    ``overrides`` replaced. An unsupported shape raises ``ValueError``."""
    model = get_model_config(arch)
    if shape not in supported_shapes(model):
        raise ValueError(
            f"shape {shape!r} not supported for arch {arch!r} "
            f"(supported: {supported_shapes(model)})")
    mesh = MULTI_POD if multi_pod else SINGLE_POD
    rc = RunConfig(model=model, shape=SHAPES[shape], mesh=mesh)
    if overrides:
        rc = rc.replace(**overrides)
    return rc
