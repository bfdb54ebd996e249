"""The CPU sizes of the cells whose configurations and mixes came after
``tests/conftest.py``'s tables: entries added to its ``SMALL`` and ``MIX``
before any test module reads them (this file is loaded first). The LM
configuration runs in float32 there: at a width of 64 and 32 tokens a
bfloat16 step's rounding is not the published widths' (its cell's limits
are set from those), and the control, the reference in bfloat16, then
stands apart from a float32 program all the more."""
from perfbench.tests import conftest as tables

tables.SMALL.setdefault("ai21-jamba2-3b", dict(
    hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=1,
    mamba_dt_rank=8, num_hidden_layers=8, attn_layer_period=4, attn_layer_offset=3,
    vocab_size=256, dtype="float32"))
tables.MIX.setdefault("packed-notes-8k", dict(window=32, shard_rows=4, doc_median=8,
                                              q_block=16, kv_block=16))
tables.MIX.setdefault("radiograph-bursts", dict(horizon=32, period=8, burst_len=2,
                                                shard_rows=30, check_requests=24))
