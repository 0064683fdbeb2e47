"""Checkpointing and fault tolerance for one process.

Ported: ``checkpoint`` and ``fault_tolerance``.  Not ported yet:
``sharding``, ``compression`` and ``pipeline``.
"""
