"""The LM family: shared layers, GQA and MLA attention, MoE, and the
decoder-only LM with its train, prefill and decode steps."""
