"""Performance switches the port's models read — from the reference's
``repro/models/flags.py``, the switch of the mesh decode only.

``DECODE_ATTN_SHARDED``: on a mesh, decode attention over a KV cache whose
sequence is split over the model axis (flash-decoding with a log-sum-exp
combine, ``models/attention.py``). Off by default, as in the reference.
The reference's analysis switches (scan unrolling, remat policy, SSD chunk
and bf16 overrides) come with the dry run; ``pallas_enabled`` and
``pallas_interpret`` have no counterpart (the port's kernels run on CUDA
tensors, their plain versions on CPU tensors).
"""
DECODE_ATTN_SHARDED = False


def set_perf(decode_sharded=None) -> None:
    """Set the switches given (the reference's ``set_perf``, its
    ``decode_sharded`` argument)."""
    global DECODE_ATTN_SHARDED
    if decode_sharded is not None:
        DECODE_ATTN_SHARDED = bool(decode_sharded)
