"""Frozen copies of what defines the benchmark's input: the LUBM generator and ontology."""
