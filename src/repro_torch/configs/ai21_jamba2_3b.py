"""AI21 Jamba2 3B [hf:ai21labs/AI21-Jamba2-3B, config.json; arXiv:2403.19887].

28 layers of width 2,560: Mamba-1 mixers (d_state 16, d_conv 4, expand 2,
dt_rank 160, a conv bias, no projection bias, RMSNorms on dt, B and C) and,
at 1 of every 14 layers (``attn_layer_period`` 14, ``attn_layer_offset``
7: layers 7 and 21), attention of 20 query heads of 128 over one KV head
with no positional encoding; a SwiGLU FFN of 8,192 in every layer
(``num_experts`` 1, so no MoE); vocabulary 65,536; RMSNorm eps 1e-6;
bfloat16.

The one departure from the source: its head is tied to the embedding
(``tie_word_embeddings``), and the split unties it
(``core.distributed.untie``), since a tied head would hand every
hospital's embedding to the server; untied it has 3.20 B parameters. The
catalog does not give the order of the layer kinds; i is attention iff
``i % 14 == 7``, HF Jamba's convention. Not registered (see
``configs/jamba.py``).
"""
from repro_torch.configs.jamba import JambaConfig

CONFIG = JambaConfig(
    name="ai21-jamba2-3b",
    family="hybrid",
    n_layers=28,
    d_model=2560,
    n_heads=20,
    n_kv_heads=1,
    d_ff=8192,
    vocab_size=65_536,
    head_dim=128,
    attn_period=14,
    attn_offset=7,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    dt_rank=160,
    norm_eps=1e-6,
    tie_embeddings=True,
    citation="hf:ai21labs/AI21-Jamba2-3B",
)
