"""Model and shape configurations of the port (a copy of
``repro.configs.base``).

``ModelConfig`` is a copy of the JAX package's frozen dataclass: its fields,
the derived values (``padded_vocab``, the analytic ``param_count``) and
``reduced()``; ``ShapeConfig`` names one (seq_len, global_batch) workload
shape; ``register``, ``get_config`` and ``all_configs`` keep a registry of
the configurations the port can build.  Configs are pure data: models are
built from them by ``repro_torch.models.registry.build_model``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

MODEL_AXIS_SIZE = 16  # the reference mesh's model-axis width (vocab padding)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class ShapeConfig:
    """One (seq_len, global_batch) workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long_decode"

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    source: str = ""

    # trunk dims
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # MLP / norm / embedding details
    mlp_type: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)

    # attention structure
    attention_kind: str = "full"  # full | local_global | swa
    window_size: int = 0
    layer_kinds: Optional[Tuple[str, ...]] = None  # per-layer variant tags

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    router_aux_loss: float = 0.01

    # MLA (deepseek-style latent attention)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    conv_kernel: int = 4
    num_meta_tokens: int = 0
    proj_factor: float = 2.0

    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False

    # vlm
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # distribution hints (read by the reference; the port runs on one card)
    shard_heads: bool = True
    scan_layers: bool = True
    remat: bool = True  # recompute each layer in the backward pass

    # --- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, MODEL_AXIS_SIZE * 8)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (trunk, embeddings, heads), as the
        reference computes it: it counts four norm vectors a layer and no
        qkv biases, so it is not the size of the parameter tree
        (``repro_torch.models.param.count_params`` of ``describe()``)."""
        d, L, V = self.d_model, self.num_layers, self.padded_vocab
        emb = V * d
        out = 0 if self.tie_embeddings else V * d
        per_layer = self._per_layer_params()
        enc = 0
        if self.encoder_layers:
            enc_attn = 4 * d * d
            enc_mlp = 2 * d * self.d_ff
            enc = self.encoder_layers * (enc_attn + enc_mlp + 4 * d)
        return emb + out + L * per_layer + enc

    def active_param_count(self) -> int:
        """Active params per token (== param_count for dense)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        moe_layers = L - self.first_k_dense
        inactive_experts = self.num_experts - self.num_experts_per_tok
        per_expert = 3 * d * self.moe_d_ff
        return self.param_count() - moe_layers * inactive_experts * per_expert

    def _per_layer_params(self) -> int:
        d = self.d_model
        # attention
        if self.use_mla:
            qdim = self.num_heads * (self.qk_nope_head_dim +
                                     self.qk_rope_head_dim)
            attn = (
                d * qdim  # q proj
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)  # kv down
                + self.kv_lora_rank
                * self.num_heads
                * (self.qk_nope_head_dim + self.v_head_dim)  # kv up
                + self.num_heads * self.v_head_dim * d  # o proj
            )
        else:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        # mlp
        gate_mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        if self.is_moe:
            mlp = (
                self.num_experts * gate_mult * d * self.moe_d_ff
                + self.num_shared_experts * gate_mult * d * self.moe_d_ff
                + d * self.num_experts  # router
            )
        elif self.family == "ssm":
            inner = int(self.proj_factor * d)
            mlp = 2 * d * inner + 3 * inner * inner // 4  # block projections
        else:
            mlp = gate_mult * d * self.d_ff
        if self.family == "hybrid":
            inner = self.q_dim
            mlp += 2 * d * inner // 2 + inner * self.ssm_state * 2  # mamba
        return attn + mlp + 4 * d  # + norms

    # --- reduced smoke config ---------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (as the reference's)."""
        kw = dict(
            num_layers=min(self.num_layers, 2 if not self.layer_kinds else 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            scan_layers=False,
            remat=False,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            window_size=min(self.window_size, 8) if self.window_size else 0,
            num_meta_tokens=min(self.num_meta_tokens, 4),
        )
        if self.is_moe:
            kw.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=32,
                      num_shared_experts=min(self.num_shared_experts, 1))
        if self.use_mla:
            kw.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16)
        if self.mrope:
            h = kw["head_dim"] // 2
            a = h // 4
            kw["mrope_sections"] = (h - 2 * a, a, a)
        if self.layer_kinds is not None:
            kw["layer_kinds"] = _reduced_layer_kinds(self.layer_kinds,
                                                     kw["num_layers"])
        return dataclasses.replace(self, **kw)


def _reduced_layer_kinds(kinds: Sequence[str], n: int) -> Tuple[str, ...]:
    """Keep the variant mix (at least one of each tag) in a short stack."""
    uniq = []
    for k in kinds:
        if k not in uniq:
            uniq.append(k)
    out = [kinds[0]] * n
    for i, k in enumerate(uniq):
        out[min(i, n - 1)] = k
    # keep dense-first invariants (deepseek): dense tag must stay at index 0
    if kinds[0] != kinds[-1] and kinds.count(kinds[0]) == 1:
        out[0] = kinds[0]
        for i, k in enumerate(uniq):
            if k != kinds[0]:
                out[min(1 + i, n - 1)] = k
    return tuple(out)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """The registered configuration called ``name``."""
    if name not in _REGISTRY:
        from repro_torch import configs as _c
        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict:
    """Every configuration the port can build, by name."""
    from repro_torch import configs as _c
    _c.load_all()
    return dict(_REGISTRY)
