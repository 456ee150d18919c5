"""A training step's share of the card's float32 peak: the operations of
the traced steps (blend forward and backward per passing step, projection
per visible row, Adam per parameter; ``benchmark.reference.counting``)
over the window's mean step time x 67 TFLOP/s."""

from benchmark.reference import counting


def read(ctx):
    counts = ctx.get("counts")
    if not counts or "param_elems" not in counts[0]:
        return None
    ops = sum(counting.train_step_ops(c["passes"], c["visible"],
                                      c["param_elems"]) for c in counts)
    return 100.0 * ops / len(counts) / (ctx["request_s"]
                                        * counting.PEAK_FLOP_S)
