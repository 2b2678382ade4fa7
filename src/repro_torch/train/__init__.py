"""AdamW and the fault-tolerant training loop."""
