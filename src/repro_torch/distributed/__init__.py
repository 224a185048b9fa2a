"""The single-process parts of the reference's distributed layer: the step
health monitor (``distributed/fault_tolerance.py``). The mesh and sharding
layers come in a later slice."""
