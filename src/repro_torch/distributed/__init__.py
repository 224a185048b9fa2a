"""The reference's distributed layer on ``torch.distributed`` (one process a
rank, explicit SPMD): starting a process group (``process_group.py``), the
collectives of the model's explicit bodies and their gradients
(``collectives.py``), the logical-axis sharding rules and the whole-tree /
block helpers (``sharding_rules.py``), GPipe over the pod axis
(``pipeline.py``) and the step health monitor
(``fault_tolerance.py``). The mesh itself is ``launch/mesh.py``."""
