"""Moonlight-16B-A3B — DeepSeek-V3 architecture: latent attention, 64 routed
experts top-6 (sigmoid scores, a selection bias) and 2 shared experts
[https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json;
``model_type`` deepseek_v3].

At its published sizes: 27 layers (layer 0 a dense SwiGLU of 11264,
``first_k_dense_replace`` 1), d 2048, 16 heads (nope 128 + rope 64 a query
and key head, value 128), ``kv_lora_rank`` 512, ``q_lora_rank`` null,
``rope_theta`` 50000 without scaling, ``rms_norm_eps`` 1e-5, vocabulary
163840 with an untied head, no multi-token-prediction layers; about 15.96 B
parameters.  Departures:

* RoPE rotates the 64-wide part in the port's half-split convention; the
  source pairs interleaved columns, which is the same model after a fixed
  permutation of ``wq``'s and ``wkv_a``'s rope columns.
* ``e_score_correction_bias`` is drawn with the weights: the published
  values are not in the source's config.
* Group-limited routing is left out: with ``n_group`` = ``topk_group`` = 1
  it is plain top-k (the routing raises on more groups).

Not in the registry (``list_archs``): the registry is the JAX package's.
"""
from repro_torch.configs.base import MLAMoEConfig, QuantConfig, mla_moe_pattern

CONFIG = MLAMoEConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,
    vocab_size=163840,
    head_dim=192,
    block_pattern=mla_moe_pattern(27, 1),
    n_experts=64,
    experts_per_token=6,
    rope_theta=50000.0,
    norm_eps=1e-5,
    tie_embeddings=False,
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json]",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe_d_ff=1408,
    n_shared_experts=2,
    routed_scaling_factor=2.446,
    norm_topk_prob=True,
    scoring_func="sigmoid",
    n_group=1,
    topk_group=1,
)
