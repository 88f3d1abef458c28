"""The window's share of the card's bf16 peak (%): the model FLOPs of the
window's work by the frozen count of the configuration's family (every
scored record's forward, or each completed step's forward and backward,
``run.counters["model_flops"]``) over 989 TFLOP/s × the window."""

from portbench import counts


def read(run):
    flops = run.counters.get("model_flops")
    if not flops:
        return None
    return 100.0 * flops / (counts.PEAK_BF16_TC * run.window_s)
