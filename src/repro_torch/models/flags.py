"""Analysis and performance switches the port's models read — the port's
``repro/models/flags.py``.

``ANALYSIS_UNROLL``: the reference sets it while the dry run compiles its
probes, because XLA's cost analysis counts a while-loop body once; every
``lax.scan`` then unrolls and the chunk sizes grow. The port's loops are
Python loops, and the dry run counts each layer and each chunk as it runs
(``roofline/count.py``), so :func:`scan_unroll` changes nothing here. What
the switch does change is the reference's chunk choices, which the port's
readers follow: the plain attention's KV chunk (2048, not 512;
``models/attention.py``, ``models/encdec.py``), the SSD chunk
(``SSD_CHUNK or 512``, not 128; ``models/ssm.py``) and the loss's sequence
chunk (4096; ``transformer.fused_lm_loss``).

Performance switches (the reference's §Perf hillclimb); all off is the
baseline:

* ``ATTN_COMPUTE_BF16``: the plain attention's products in the inputs'
  dtype (bf16) with float32 softmax statistics
  (``kernels/flash_attention/ref.py``). The kernels compute so in bf16
  already: on CUDA tensors a bf16 model launches their bf16 modes.
* ``REMAT_POLICY``: what a rematerialised layer keeps. ``"nothing"``
  recomputes the whole layer in the backward; ``"dots"`` keeps the outputs
  of its products — every ``mm`` call, the matmul kernel on the card — and
  recomputes the rest (:func:`remat_policy`, read by
  ``layers.maybe_checkpoint``).
* ``SSD_CHUNK``: the SSD chunk when no tile is given (0: the default).
* ``SSD_COMPUTE_BF16``: the plain SSD scan's intra-chunk products in bf16,
  decay statistics in float32 (``kernels/ssd/ref.py``); on CUDA tensors a
  bf16 model runs the kernels' bf16 mode.
* ``DECODE_ATTN_SHARDED``: on a mesh, decode attention over a KV cache
  whose sequence is split over the model axis (flash-decoding with a
  log-sum-exp combine, ``models/attention.py``).

``pallas_enabled`` and ``pallas_interpret`` have no counterpart: the
port's kernels run on CUDA tensors and their plain versions on CPU
tensors, whatever a switch says.
"""
ANALYSIS_UNROLL = False

ATTN_COMPUTE_BF16 = False
REMAT_POLICY = "nothing"
SSD_CHUNK = 0
SSD_COMPUTE_BF16 = False
DECODE_ATTN_SHARDED = False


def set_analysis_unroll(value: bool) -> None:
    global ANALYSIS_UNROLL
    ANALYSIS_UNROLL = bool(value)


def set_perf(attn_bf16=None, remat=None, ssd_chunk=None,
             decode_sharded=None, ssd_bf16=None) -> None:
    """Set the switches given (the reference's ``set_perf``)."""
    global ATTN_COMPUTE_BF16, REMAT_POLICY, SSD_CHUNK, DECODE_ATTN_SHARDED
    global SSD_COMPUTE_BF16
    if ssd_bf16 is not None:
        SSD_COMPUTE_BF16 = bool(ssd_bf16)
    if attn_bf16 is not None:
        ATTN_COMPUTE_BF16 = bool(attn_bf16)
    if remat is not None:
        assert remat in ("nothing", "dots")
        REMAT_POLICY = remat
    if ssd_chunk is not None:
        SSD_CHUNK = int(ssd_chunk)
    if decode_sharded is not None:
        DECODE_ATTN_SHARDED = bool(decode_sharded)


def remat_policy() -> str:
    """What a checkpointed layer saves: ``"dots"`` (its products' outputs)
    or ``"nothing"``."""
    return REMAT_POLICY


def scan_unroll():
    """The reference passes this as ``lax.scan(..., unroll=)``; the port
    runs its loops in Python and counts each step, so it is only read."""
    return True if ANALYSIS_UNROLL else 1
