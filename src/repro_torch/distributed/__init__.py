"""The distributed layer on ``torch.distributed``.

``sharding`` (specs, placements, ``distribute``), ``compression``
(EF-int8 gradient all-reduce), ``pipeline`` (GPipe over the pod axis),
``checkpoint`` (atomic async checkpoints, elastic restore onto a mesh)
and ``fault_tolerance``.
"""
