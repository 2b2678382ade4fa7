"""The multi-process runtime: a ``torch.distributed`` process group and
the cards each process owns (``runtime.py``)."""
