"""The multi-process runtime: a ``torch.distributed`` process group and
the cards each process owns (``runtime.py``); checkpoints in the
reference's format (``checkpoint.py``)."""
