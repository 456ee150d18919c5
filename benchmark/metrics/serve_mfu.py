"""A served frame's share of the card's float32 peak: the operations of
the traced frames (blend per passing step, projection per visible row;
``benchmark.reference.counting``) over the window's mean frame time x 67
TFLOP/s."""

from benchmark.reference import counting


def read(ctx):
    counts = ctx.get("counts")
    if not counts:
        return None
    ops = sum(counting.serve_frame_ops(c["passes"], c["visible"])
              for c in counts)
    return 100.0 * ops / len(counts) / (ctx["request_s"]
                                        * counting.PEAK_FLOP_S)
