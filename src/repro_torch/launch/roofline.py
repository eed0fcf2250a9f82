"""The communication model of the bucketed gradient collective: the
counterpart of the gradient-collective part of ``repro/launch/roofline.py``
(the rest of that module, the byte and flop formulas, is not ported yet).

The constants are the H100's, not the reference's:

  * ``LINK_BW``: NVLink between the cards of one host, 900 GB/s all to
    all, 450 GB/s each way (NVIDIA's data sheet, H100 SXM);
  * ``COLLECTIVE_LAUNCH_S``: the fixed cost of one collective, an NCCL
    all-gather of 64 bytes at world size 1 on an NVIDIA H100 80GB HBM3
    at a 700 W power limit: 65.1 µs a call over 500 back-to-back calls,
    as long as the host takes to issue one (``chip_smoke.py`` phase 6
    logs it as ``[dp] nccl launch``; an all-reduce took 51.5 µs; other
    calls read 128.5 and 145 µs for the all-gather: the host's cost moves
    between machines).  One card can time no other collective: a ring
    across cards adds its hops to this host cost.
    The value only has to be of the right order to keep the bucket
    chooser out of the latency-bound regime.
"""
from __future__ import annotations

#: NVLink bandwidth each way between two cards of one H100 host, bytes/s
LINK_BW = 450e9

#: one collective's fixed cost in seconds (an NCCL all-gather of 64 bytes
#: at world size 1 on the H100, chip_smoke.py phase 6; see the docstring)
COLLECTIVE_LAUNCH_S = 65e-6

#: buckets the overlap wants in flight per shard: more buckets give finer
#: interleaving, fewer less launch overhead
TARGET_OVERLAP_BUCKETS = 8


def ring_collective_seconds(nbytes: int, ndev: int, *, bw: float = LINK_BW,
                            launch: float = COLLECTIVE_LAUNCH_S) -> float:
    """Ring reduce-scatter + all-gather time for ``nbytes`` of payload:
    each phase moves ``(ndev-1)/ndev * nbytes`` per link."""
    if ndev <= 1:
        return 0.0
    return launch + 2.0 * (ndev - 1) / ndev * nbytes / bw


def ring_phase_seconds(nbytes: int, ndev: int, *, bw: float = LINK_BW,
                       launch: float = COLLECTIVE_LAUNCH_S) -> float:
    """ONE ring phase (a reduce-scatter OR an all-gather) of ``nbytes``."""
    if ndev <= 1:
        return 0.0
    return launch + (ndev - 1) / ndev * nbytes / bw


def exposed_comm_seconds(bucket_elems_list, ndev: int,
                         compute_budget_s: float, *, block: int = 256,
                         bw: float = LINK_BW,
                         launch: float = COLLECTIVE_LAUNCH_S) -> float:
    """Event-driven exposed-communication model of a bucket schedule.

    Bucket ``j``'s compressed reduction (an fp32 ring reduce-scatter, then
    an int8 + scales ring all-gather) joins one channel the moment its
    share of the backward has been produced, modelled as ready at
    ``compute_budget_s * (j + 1) / B``.  What the channel still owes once
    compute is done is exposed:

        exposed = max(0, channel_finish - compute_budget_s)

    The monolithic schedule is the one-bucket case: ready only when the
    backward completes, so all of its wire time is exposed."""
    buckets = [int(n) for n in bucket_elems_list]
    B = len(buckets)
    channel = 0.0
    for j, n in enumerate(buckets):
        ready = compute_budget_s * (j + 1) / B
        wire = (ring_phase_seconds(4 * n, ndev, bw=bw, launch=launch)
                + ring_phase_seconds(n + 4 * (-(-n // block)), ndev,
                                     bw=bw, launch=launch))
        channel = max(channel, ready) + wire
    return max(0.0, channel - compute_budget_s)


def choose_bucket_elems(total_elems: int, ndev: int, *, block: int = 256,
                        bytes_per_elem: float = 1.0 + 4.0 / 256,
                        target_buckets: int = TARGET_OVERLAP_BUCKETS,
                        bw: float = LINK_BW,
                        launch: float = COLLECTIVE_LAUNCH_S) -> int:
    """Bucket size (elements) of the bucketed compressed all-reduce.

    Overlap wants many buckets (``TARGET_OVERLAP_BUCKETS`` a shard); the
    launch cost wants few: the floor is the size at which the launch is at
    most 10% of a bucket's ring wire time.  ``bytes_per_elem`` defaults to
    the int8-plus-scales wire format.  The result is a multiple of
    ``block * ndev``, so every rank's segment stays aligned with the
    quantization blocks."""
    align = block * max(1, ndev)
    if total_elems <= align:
        return total_elems
    wire_bw = bw / max(1, 2 * (ndev - 1)) * max(1, ndev) if ndev > 1 else bw
    floor_elems = int(10.0 * launch * wire_bw / bytes_per_elem)
    want = max(floor_elems, total_elems // max(1, target_buckets))
    want = min(want, total_elems)
    b = -(-want // align) * align
    return min(b, total_elems)
