"""Config system for repro_torch (a copy of ``repro.configs.base``).

A ``ModelConfig`` fully determines an architecture; a ``ShapeConfig`` is one
of the assigned input-shape cells; a ``MeshConfig`` names the device mesh;
``RunConfig`` bundles them with training hyper-parameters (including the
paper's importance-sampling knobs).

Architectures are registered in ``repro_torch.configs`` (one module per arch) and
selected with ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# Block kinds (entries of a layer pattern)
# ---------------------------------------------------------------------------
ATTN = "attn"                # global self-attention (GQA)
ATTN_LOCAL = "attn_local"    # sliding-window self-attention
ATTN_MLA = "attn_mla"        # multi-head latent attention (deepseek-v2)
SHARED_ATTN = "shared_attn"  # zamba2: single shared attention block reused
MAMBA2 = "mamba2"            # Mamba2 / SSD block
MLSTM = "mlstm"              # xLSTM matrix-memory block
SLSTM = "slstm"              # xLSTM scalar-memory block (sequential)

ATTENTION_KINDS = (ATTN, ATTN_LOCAL, ATTN_MLA, SHARED_ATTN)
RECURRENT_KINDS = (MAMBA2, MLSTM, SLSTM)


@dataclass(frozen=True)
class Segment:
    """A homogeneous, scannable run of layers.

    ``pattern`` is applied ``repeats`` times in sequence; parameters for each
    pattern position are stacked over ``repeats`` and the stack is traversed
    with ``lax.scan`` so compile time is O(len(pattern)), not O(layers).
    """

    pattern: tuple  # tuple[str, ...] of block kinds
    repeats: int
    dense_ffn: bool = False   # force dense FFN even when cfg.moe is set
                              # (deepseek-v2: first layer is dense)

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_experts_pad: int = 0        # pad expert AXIS to this (0 = no pad) so
                                  # EP divides the TP degree (granite 40->48;
                                  # dead experts are never routed to)
    top_k: int = 0
    d_expert: int = 0             # per-expert FFN hidden size
    n_shared_experts: int = 0     # always-on experts (deepseek-v2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # sharding: "ep" shards the expert axis over the model axis; "tp" shards
    # each expert's hidden dim instead (for n_experts not divisible by TP).
    shard_mode: str = "auto"


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: tuple               # tuple[Segment, ...]
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    sliding_window: int = 1024    # used by ATTN_LOCAL blocks
    tie_embeddings: bool = False
    act: str = "swiglu"           # swiglu | gelu
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # modality frontend stub: "tokens" feeds ids; "embeddings" feeds
    # precomputed frame/patch embeddings of shape (batch, seq, d_model);
    # "tokens+image" (llava) prepends n_prefix_embeds patch embeddings.
    input_mode: str = "tokens"
    n_prefix_embeds: int = 0
    dtype: str = "bfloat16"
    # does any block give sub-quadratic/persistent-state decode?
    # (used to decide long_500k applicability)

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.segments)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def block_kinds(self) -> tuple:
        ks = []
        for s in self.segments:
            ks.extend(s.pattern)
        return tuple(dict.fromkeys(ks))

    @property
    def is_subquadratic(self) -> bool:
        """True when every non-shared block is recurrent/local (long-context OK)."""
        ks = set()
        for s in self.segments:
            ks.update(s.pattern)
        quad = {ATTN, ATTN_MLA} & ks
        return not quad or ks <= {MAMBA2, MLSTM, SLSTM, ATTN_LOCAL, SHARED_ATTN}

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), used for roofline
        MODEL_FLOPS = 6 N D."""
        from repro_torch.models.counting import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_params
        return count_params(self, active_only=True)


# ---------------------------------------------------------------------------
# Input shapes (the assigned 4-cell set for LM transformers)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(cfg: ModelConfig):
    """The assigned shape cells that are well-defined for this arch.

    ``long_500k`` needs sub-quadratic attention: run for SSM/hybrid archs,
    skip (and record the skip) for pure full-attention archs per assignment.
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.is_subquadratic:
        out.append(LONG_500K)
    return out


# ---------------------------------------------------------------------------
# Importance sampling (the paper's knobs — Algorithm 1)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ISConfig:
    enabled: bool = True
    presample_ratio: int = 3       # B = ratio * b  (paper: 2 < B/b < 6)
    tau_th: float = 0.0            # 0 -> derive from eq. 26: (B+3b)/(3b)
    ema: float = 0.9               # a_tau
    # scoring implementation: "naive" materialises the softmax gradient
    # (paper-faithful reference), "fused" uses direct sharded reductions
    # (production default), "chunked" streams vocab tiles (CPU benches),
    # "pallas" uses the fused TPU kernel.
    score_impl: str = "fused"
    score_dtype: str = "bfloat16"
    # sampling score: "upper-bound" (the paper's Ĝ, eq. 20) or "loss"
    # (the Loshchilov/Schaul-style baseline the paper compares against)
    score_by: str = "upper-bound"
    # BEYOND-PAPER (the paper's §5 future work): when IS is active the
    # gradient variance drops as if the batch were τ× larger, so the lr can
    # scale like a √τ batch-size-scaling rule (capped). 0 disables.
    lr_tau_boost_cap: float = 0.0
    # decoupled scoring engine (repro.scoring): overlap the engine's
    # forward-only score pass for batch k+1 with batch k's update (scores
    # go one step stale — selection tolerates that). Only applies to
    # engine-backed host-side schemes (sampler.host_score).
    overlap_scoring: bool = True
    # store-backed selection plane (history / selective): "gather" rebuilds
    # the full O(n) global score vector per plan (exact PR-4 semantics,
    # bitwise identical at any host count); "sharded" selects from score
    # shards — Gumbel/exponential top-k candidate exchange + O(1)
    # sufficient-stat collectives, O(n/H + b·H) per plan instead of O(n).
    # "auto" (default) picks from the measured H/n crossover in
    # BENCH_selection.json: gather below n ≈ 24·b·H (and always at H=1,
    # where the strided gather is an identity), sharded above it. See
    # repro.sampler.selection.resolve_selection_impl.
    selection_impl: str = "auto"
    # presample execution path: "step" runs Algorithm 1 inside the jitted
    # train step (score+resample on device, b·ratio rows shipped every
    # step); "host" is the engine-backed host path (sampler.host_score's
    # spelling as a first-class knob); "fused" keeps the candidate pool
    # device-resident — the engine scores it in place and the selected
    # rows are gathered ON DEVICE (repro.kernels.fused_presample), so
    # only the B-float score vector crosses the host boundary. "auto"
    # defers to sampler.host_score ("host" when set, else "step").
    presample_impl: str = "auto"
    # survival pruning of the presample scoring pass: "conservative"
    # chunks the pool's CE over time-blocks and stops scoring rows whose
    # race-key lower bound E_i/ŝ_i already exceeds the running (k+1)-th
    # key upper bound — the surviving top-(b+1) is EXACTLY the unpruned
    # one, so plans stay bitwise identical across the pruned / unpruned
    # fused / host_score paths (which all switch to the survivor-closed
    # plan math: raw race keys + HT-estimated τ̂, see
    # selection.presample_race_select_raw). "off" (default) is the PR-7
    # byte-exact full-scoring path. Saves ~(1−1/ratio) of scoring flops
    # on concentrated pools (kernels.prune.* counters carry the receipt).
    score_prune: str = "off"

    def resolved_tau_th(self, b: int) -> float:
        if self.tau_th > 0:
            return self.tau_th
        B = self.presample_ratio * b
        return (B + 3 * b) / (3 * b)


@dataclass(frozen=True)
class SamplerConfig:
    """Persistent score-memory sampling (``repro.sampler``).

    ``presample`` is the paper's Algorithm 1 (per-batch scoring pass);
    ``history`` does dataset-level IS from the persistent ``ScoreStore``
    (scores are free — reused from training batches); ``selective`` is
    Biggest-Losers-style top-k selective backprop; ``uniform`` is the
    baseline. All schemes feed per-sample scores back into the store.
    """
    scheme: str = "presample"     # uniform | presample | history | selective
    ema: float = 0.9              # score-memory EMA merge rate
    staleness: float = 0.9        # per-epoch decay of score deviations
                                  # toward the mean (stale scores flatten)
    smoothing: float = 0.1        # λ: p = (1-λ)·p_score + λ·uniform
    temperature: float = 1.0      # p_score ∝ score^(1/T)
    tau_th: float = 0.0           # history gate threshold; 0 → 1.05 (scores
                                  # are free, so any τ>1 is variance won)
    min_coverage: float = 0.5     # history: store coverage before IS engages
    selective_window: int = 0     # selective candidate window W
                                  # (0 → presample_ratio × b)
    gate_every: int = 8           # refresh the store-τ gate every N steps
                                  # (computing τ is O(n/hosts) host work;
                                  # the store's own EMA smooths the signal)
    host_score: bool = False      # presample only: score the B candidates
                                  # on the host path via the decoupled
                                  # ScoreEngine (enables overlapped scoring
                                  # + out-of-band ScoreStore refresh)
                                  # instead of inside the jitted train step

    def resolved_tau_th(self) -> float:
        return self.tau_th if self.tau_th > 0 else 1.05


@dataclass(frozen=True)
class DataConfig:
    """The pipelined data plane (``repro.data.pipeline.DataPlane``).

    ``prefetch_depth`` bounds how many batches the plan → gather →
    device-put pipeline keeps in flight (1 = the old single-slot
    prefetch); pipelining only applies to schemes whose plans are pure
    functions of the pipeline cursor (uniform / presample) — store- and
    engine-coupled schemes keep the two-phase begin/finish overlap.
    """
    prefetch_depth: int = 2       # batches in flight (>=1)
    device_put: bool = True       # stage 3: H2D transfer on the worker


@dataclass(frozen=True)
class ObsConfig:
    """The telemetry plane (``repro.obs``).

    Disabled, instrumentation costs a couple of attribute checks per
    record site; enabled, the registry collects loop/data-plane/
    collective/store/IS-health metrics and the ``TelemetryHook``
    flushes snapshots to the configured sink every ``flush_every``
    accepted steps. On by default in the ``prod`` preset; the config
    snapshot rides the checkpoint manifest like every other section.
    """
    enabled: bool = False
    sink: str = "jsonl"           # jsonl | console | tensorboard | none
    dir: str = "/tmp/repro_obs"   # sink output directory (per-process files)
    flush_every: int = 10         # steps between sink flushes
    rotate_mb: float = 64.0       # jsonl size-based rotation threshold


@dataclass(frozen=True)
class FaultsConfig:
    """Deterministic fault injection (``repro.runtime.faults``).

    ``spec`` is a seeded schedule, ``;``-separated entries of the form
    ``kind@step[:host[:arg]]`` — e.g. ``"timeout@3:1;die@8:1;slow@5:0:0.4"``.
    Kinds: ``timeout`` (a collective attempt raises an injected deadline
    error; ``arg`` = how many attempts fail, default 1), ``gather`` (one
    injected data-plane gather error at that step), ``die`` (the targeted
    host exits abruptly — host death), ``slow`` (``arg`` seconds added to
    the step's measured wall time — a deterministic straggler, no real
    sleep). ``host`` omitted → every host. Off by default and free when
    disabled (one attribute check per site — the ``repro.obs``
    discipline).
    """
    enabled: bool = False
    seed: int = 0
    spec: str = ""


@dataclass(frozen=True)
class RuntimeConfig:
    """Elastic membership runtime (``repro.runtime``).

    Deadline-guards every production collective: each attempt gets
    ``collective_timeout_s``; a timed-out attempt is retried up to
    ``collective_retries`` times with bounded exponential backoff
    (``backoff_base_s`` doubling, capped at ``backoff_max_s``); a
    persistent timeout escalates into a ``MembershipChange`` event
    instead of hanging the pod. ``faults`` is the deterministic
    fault-injection schedule used by the chaos tests.
    """
    collective_timeout_s: float = 120.0
    collective_retries: int = 2
    backoff_base_s: float = 0.5
    backoff_max_s: float = 8.0
    faults: FaultsConfig = field(default_factory=FaultsConfig)


@dataclass(frozen=True)
class OptimConfig:
    name: str = "sgd"              # sgd | adamw
    lr: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 5e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # cross-pod gradient compression: none | int8 | topk
    compression: str = "none"
    topk_frac: float = 0.01
    zero1: bool = True             # shard optimizer state over data axis


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig = TRAIN_4K
    optim: OptimConfig = field(default_factory=OptimConfig)
    imp: ISConfig = field(default_factory=ISConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    steps: int = 100
    microbatches: int = 1          # gradient accumulation
    remat: bool = True
    seed: int = 0
    # fault tolerance
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    step_deadline_factor: float = 2.0   # straggler guard
    max_step_retries: int = 3           # per-batch retries after a
                                        # straggler skip (the batch is
                                        # RETRIED, never silently dropped)


def reduced(cfg: ModelConfig, *, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=256, repeats=1) -> ModelConfig:
    """A tiny same-family variant of ``cfg`` for CPU smoke tests."""
    segs = tuple(Segment(s.pattern, min(s.repeats, repeats)) for s in cfg.segments)
    hd = max(8, d_model // n_heads)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=min(n_kv_heads, n_heads),
        d_ff=d_ff if cfg.d_ff else 0,
        vocab_size=vocab,
        head_dim=hd,
        segments=segs,
        sliding_window=min(cfg.sliding_window, 64) or 64,
        moe=dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert, 64) if cfg.moe.d_expert else 0,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
        ),
        mla=dataclasses.replace(
            cfg.mla, q_lora_rank=32, kv_lora_rank=16,
            rope_head_dim=8, nope_head_dim=hd, v_head_dim=hd),
        ssm=dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16),
        n_prefix_embeds=min(cfg.n_prefix_embeds, 8),
        dtype="float32",
    )
